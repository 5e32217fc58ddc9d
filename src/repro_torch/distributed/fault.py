"""Host-level fault tolerance: stragglers, failures, elastic re-meshing —
the port's own copy of ``repro.distributed.fault`` (plain Python), so that
the port imports nothing of the JAX package.

The policies run in the host process, outside any device program, and are
deliberately simple and testable:

* ``StragglerMonitor`` — per-step wall-time watermarks.  A step slower than
  ``threshold×`` the trailing median flags a straggler; after ``patience``
  consecutive flags the launcher should trigger a checkpoint + re-mesh
  (slow-host exclusion).  This is the single-program analogue of backup
  tasks: one shard of a lock-step program cannot be re-executed alone, so
  the mesh shrinks instead.
* ``ElasticPolicy`` — given the surviving device count, choose the largest
  supported mesh shape ≤ available devices and report it.  Shapes are kept
  to (pods × rows × cols) factorable forms so sharding specs stay valid.
* ``RetryPolicy`` — transient-failure retry with exponential backoff; the
  shard fetch of ``core/tiered.py`` reads through it.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import random
import statistics
import time
from typing import Callable, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    patience: int = 3
    window: int = 32

    def __post_init__(self):
        self._times: List[float] = []
        self._flags = 0
        self._t0: Optional[float] = None

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self) -> bool:
        """Record a step; returns True when a re-mesh should be triggered."""
        assert self._t0 is not None
        dt = time.monotonic() - self._t0
        return self.observe(dt)

    def observe(self, dt: float) -> bool:
        self._times.append(dt)
        self._times = self._times[-self.window:]
        if len(self._times) < 8:
            return False
        med = statistics.median(self._times[:-1])
        if dt > self.threshold * med:
            self._flags += 1
        else:
            self._flags = 0
        return self._flags >= self.patience


@dataclasses.dataclass
class ElasticPolicy:
    """Pick the biggest valid mesh after losing chips."""

    candidate_shapes: Sequence[Tuple[int, ...]] = (
        (2, 16, 16), (16, 16), (16, 8), (8, 8), (8, 4), (4, 4), (2, 2), (1, 1),
    )

    def choose(self, available_chips: int) -> Tuple[int, ...]:
        for shape in self.candidate_shapes:
            size = 1
            for s in shape:
                size *= s
            if size <= available_chips:
                return shape
        raise RuntimeError("no devices available")


class AttemptTimeout(TimeoutError):
    """One attempt exceeded the policy's per-attempt ``timeout_s``."""


@dataclasses.dataclass
class RetryPolicy:
    """Transient-failure retry with exponential backoff (launcher level,
    and the read-retry engine of ``core/tiered.py``'s shard fetch).

    * ``retryable`` — only these exception types are retried; anything
      else (including ``KeyboardInterrupt``/``SystemExit``, which are not
      ``Exception`` subclasses) propagates immediately.  A checksum
      mismatch is retryable on purpose: a transient read glitch heals on
      re-read, real bit-rot fails every attempt and surfaces as the typed
      error after the budget is spent.
    * ``jitter`` — fraction of each delay added uniformly at random
      (seeded, so schedules are reproducible); decorrelates a fleet of
      retriers hammering the same store.
    * ``timeout_s`` — per-attempt wall-clock cap.  The attempt runs on a
      worker thread and :class:`AttemptTimeout` (retryable iff it matches
      ``retryable``) is raised when it blows the budget; the abandoned
      attempt finishes in the background — acceptable at an I/O boundary,
      never wrap device computation in it.
    * ``on_retry(attempt, delay_s, exc)`` — observability callback fired
      before each backoff sleep (attempt is 0-based); the shard fetch
      counts ``StreamIO.io_retries`` through it.  Exceptions it raises
      propagate — it is part of the control flow, not best-effort.
    """

    max_retries: int = 3
    base_delay_s: float = 1.0
    max_delay_s: float = 30.0
    jitter: float = 0.0
    retryable: Tuple[type, ...] = (Exception,)
    timeout_s: Optional[float] = None
    seed: int = 0
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None

    def delays(self) -> List[float]:
        """The deterministic pre-jitter backoff schedule (one delay per
        retry) — pinned by tests so the schedule is a contract."""
        return [min(self.base_delay_s * (2 ** a), self.max_delay_s)
                for a in range(self.max_retries)]

    def _attempt(self, fn, args, kwargs):
        if self.timeout_s is None:
            return fn(*args, **kwargs)
        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(fn, *args, **kwargs)
        try:
            return fut.result(timeout=self.timeout_s)
        except concurrent.futures.TimeoutError:
            raise AttemptTimeout(
                f"attempt exceeded {self.timeout_s}s") from None
        finally:
            # wait=False: a hung attempt must not hang the shutdown too
            ex.shutdown(wait=False)

    def run(self, fn, *args, on_retry: Optional[Callable] = None, **kwargs):
        """``fn(*args, **kwargs)`` with retries; ``on_retry`` here chains
        after the policy-level callback for per-call-site accounting."""
        rng = random.Random(self.seed) if self.jitter else None
        schedule = self.delays()
        for attempt in range(self.max_retries + 1):
            try:
                return self._attempt(fn, args, kwargs)
            except self.retryable as e:
                if attempt == self.max_retries:
                    raise
                d = schedule[attempt]
                if rng is not None:
                    d *= 1.0 + self.jitter * rng.random()
                if self.on_retry is not None:
                    self.on_retry(attempt, d, e)
                if on_retry is not None:
                    on_retry(attempt, d, e)
                time.sleep(d)
        raise AssertionError("unreachable")  # loop always returns or raises

"""Deterministic fault injection for the slow-tier I/O paths — the port's
own copy of ``repro.core.faultio`` (plain Python and numpy), so that the
port imports nothing of the JAX package.

The paper's setting is a graph that lives for months in a persistent tier
and runs for hours through it — which means the recovery paths (checksum
verify, retried reads, mid-run resume) are load-bearing code, and code
that only executes when hardware misbehaves is code that never executes
in CI unless something *makes* it.  :class:`FaultInjector` is that
something: a seeded, fully deterministic plan of faults fired at named
I/O sites, so every recovery path in ``core/tiered.py`` /
``checkpoint/store.py`` / ``core/engine.py`` is exercised by tests
(``tests/test_torch_tiered.py``), not hoped for.

Sites call ``injector.tick(op, key=...)`` (and the shard-read path the
``shard_read`` convenience, which also applies payload faults).  An op is
a site name — the ones wired today:

* ``"shard_read"`` — ``TieredGraph._fetch`` reading a host/store shard;
  ``key`` is the shard id.
* ``"round"``      — one engine round starting (``engine.run_host`` /
  ``engine.run_streamed``); ``key`` is the round number.
* ``"ckpt_write"`` — a checkpoint snapshot being written (the reference's
  ``RunCheckpointer``, not ported yet: ROADMAP queue 1, item 8: resume).

Fault kinds:

* ``eio``     — raise :class:`InjectedIOError` (an ``OSError``): the
  transient-EIO case a hardened ``RetryPolicy`` must absorb.
* ``bitflip`` — flip one seeded bit in a COPY of the payload arrays (the
  store itself is never mutated): the bit-rot case the checksum must
  catch and convert into :class:`ShardCorruptError`.
* ``torn``    — zero the tail half of the payload copies: a torn write
  read back, also a checksum catch.
* ``delay``   — ``time.sleep(delay_s)``: a latency spike; shows up in
  ``StreamIO.io_wait_us`` and trips ``StragglerMonitor`` thresholds.
* ``kill``    — ``os._exit(exit_code)``: the kill-at-round-r drill.  The
  process dies without unwinding, exactly like a SIGKILL'd host; only a
  committed checkpoint survives.

Determinism contract: firing depends only on the plan and the per-op call
counts (no wall clock, no randomness), and ``bitflip`` corruption bytes
depend only on ``seed`` and the fault's fire index — the same plan over
the same run corrupts the same bit.  ``fired`` logs every fault that
triggered, so tests can assert the plan actually executed.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np


class InjectedIOError(OSError):
    """A planned transient I/O failure (errno EIO semantics)."""


class ShardCorruptError(RuntimeError):
    """A shard's bytes do not match its recorded checksum (or its recorded
    dtype/shape) after exhausting the read retry policy: bit-rot, a torn
    write, or a store mixed from two different cuts.  Never silently
    repaired — the caller must rebuild or restore the shard."""


KINDS = ("eio", "bitflip", "torn", "delay", "kill")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire ``kind`` at site ``op`` on the ``at``-th
    matching call (0-based), for ``times`` consecutive matching calls.
    ``key`` restricts matching to one site key (e.g. one shard id) and
    switches counting to that key's own call counter."""

    op: str
    kind: str
    at: int = 0
    times: int = 1
    key: Optional[int] = None
    delay_s: float = 0.0
    exit_code: int = 7

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")


# -- plan-building conveniences (keep test plans readable) ------------------

def eio(op: str, at: int = 0, times: int = 1, key: Optional[int] = None):
    return FaultSpec(op=op, kind="eio", at=at, times=times, key=key)


def bitflip(op: str, at: int = 0, times: int = 1_000_000,
            key: Optional[int] = None):
    return FaultSpec(op=op, kind="bitflip", at=at, times=times, key=key)


def torn(op: str, at: int = 0, times: int = 1_000_000,
         key: Optional[int] = None):
    return FaultSpec(op=op, kind="torn", at=at, times=times, key=key)


def delay(op: str, delay_s: float, at: int = 0, times: int = 1,
          key: Optional[int] = None):
    return FaultSpec(op=op, kind="delay", at=at, times=times, key=key,
                     delay_s=delay_s)


def kill(op: str, at: int, key: Optional[int] = None, exit_code: int = 7):
    return FaultSpec(op=op, kind="kill", at=at, key=key,
                     exit_code=exit_code)


class FaultInjector:
    """Deterministic fault plan executor for the I/O sites above.

    One injector is attached to one run (``TieredGraph.set_fault_injector``
    / threaded into ``engine.run_host``); call counts accumulate for the
    injector's lifetime, so ``at`` indexes count retries too — an
    ``eio("shard_read", at=3, times=2)`` plan fails the 4th and 5th read
    *including* the retried re-reads, which is exactly how a transient
    window behaves.
    """

    def __init__(self, plan: Sequence[FaultSpec], seed: int = 0):
        self.plan: List[FaultSpec] = list(plan)
        self.seed = int(seed)
        self._calls: Counter = Counter()
        self._fire_no = 0
        self.fired: List[Tuple[str, str, int, Optional[int]]] = []

    # -- core matching -----------------------------------------------------
    def _matches(self, op: str, key) -> List[FaultSpec]:
        out = []
        gidx = self._calls[(op, None)]
        kidx = self._calls[(op, key)] if key is not None else gidx
        for spec in self.plan:
            if spec.op != op:
                continue
            if spec.key is not None and spec.key != key:
                continue
            idx = kidx if spec.key is not None else gidx
            if spec.at <= idx < spec.at + spec.times:
                out.append(spec)
        return out

    def tick(self, op: str, key=None) -> List[FaultSpec]:
        """Count one call at site ``op`` and execute its control-flow
        faults: ``delay`` sleeps here, ``kill`` exits the process here,
        ``eio`` raises here.  Payload faults (``bitflip`` / ``torn``) are
        returned for the caller to apply with ``corrupt_arrays``."""
        hits = self._matches(op, key)
        self._calls[(op, None)] += 1
        if key is not None:
            self._calls[(op, key)] += 1
        payload = []
        for spec in hits:
            self.fired.append((op, spec.kind, self._fire_no, key))
            self._fire_no += 1
            if spec.kind == "delay":
                time.sleep(spec.delay_s)
            elif spec.kind == "kill":
                os._exit(spec.exit_code)
            elif spec.kind == "eio":
                raise InjectedIOError(
                    5, f"injected EIO at {op}[{key}] "
                       f"(call {self._calls[(op, None)] - 1})")
            else:
                payload.append(spec)
        return payload

    # -- payload corruption ------------------------------------------------
    def corrupt_arrays(self, faults: Sequence[FaultSpec],
                       arrays: Sequence[np.ndarray]):
        """Apply ``bitflip`` / ``torn`` faults to COPIES of ``arrays``
        (the backing store is never mutated — injected corruption models
        what a *read* returned, not what the medium holds)."""
        if not faults:
            return tuple(arrays)
        out = [np.array(a, copy=True) for a in arrays]
        for spec in faults:
            if spec.kind == "bitflip":
                # seeded by (seed, fire index): deterministic per firing
                rng = np.random.default_rng((self.seed, self._fire_no))
                self._fire_no += 1
                ai = int(rng.integers(0, len(out)))
                view = out[ai].view(np.uint8).reshape(-1)
                if view.size:
                    byte = int(rng.integers(0, view.size))
                    view[byte] ^= np.uint8(1 << int(rng.integers(0, 8)))
            elif spec.kind == "torn":
                for a in out:
                    flat = a.view(np.uint8).reshape(-1)
                    flat[flat.size // 2:] = 0
        return tuple(out)

    def shard_read(self, sid: int, *arrays: np.ndarray):
        """The ``shard_read`` site in one call: count, fire control-flow
        faults (may raise/sleep/exit), and return the (possibly
        corrupted copies of the) payload arrays."""
        payload = self.tick("shard_read", key=sid)
        return self.corrupt_arrays(payload, arrays)

    # -- introspection -----------------------------------------------------
    def calls(self, op: str, key=None) -> int:
        return self._calls[(op, key)]

    def fired_kinds(self) -> Counter:
        return Counter(kind for _, kind, _, _ in self.fired)

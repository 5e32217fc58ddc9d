"""Batched graph-query serving: continuous batching over one resident graph,
as in ``repro.launch.graph_serve``.

A fixed pool of ``max_batch`` *lane* slots over a single resident graph.
Each slot is one in-flight query — a BFS / SSSP / PPR source — and every
serving tick advances ALL occupied lanes with ONE batched round through
``core.multisource.MultiSourceEngine``, so B concurrent queries share each
edge sweep (on the card, one ``edge_relax_lanes`` launch per 32 lanes).

Tick structure (one ``engine.fetch`` per tick):

0. **expire / shed** — requests past their ``deadline_ticks`` budget are
   dropped from the queue or evicted from their lane (frontier row
   cleared, slot freed so it backfills THIS tick), and a bounded ready
   queue (``max_ready``) sheds overload newest-first.  Shed requests come
   back ``done`` with ``reject_reason`` set.
1. **admit** ready arrivals into free slots: the lane's initial labels (in
   both of the dist steps' label buffers) and one-hot frontier row are
   written in place on the device (``MultiSourceEngine.reset_lane``: fills
   of the slot's row views; no host row is copied over).
2. **fetch** the union ladder scalars + per-lane ``alive`` flags in one
   transfer (``MultiSourceEngine.fetch``), after admission, so the rung
   sees the just-admitted rows.
3. **retire** occupied lanes whose row went dead: finalize the label row,
   stamp completion, free the slot for backfill next tick.
4. **round** — one batched sparse/dense relax for the fetched scalars.

On the card (a small random graph):
    PYTHONPATH=src python -m repro_torch.launch.graph_serve --requests 8
``--device cpu`` runs the plain versions on the CPU (for the tests).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..core import multisource as ms
from ..distributed.fault import StragglerMonitor

ALGOS = ("bfs", "sssp", "ppr")


class ServeStuckError(RuntimeError):
    """``GraphServer.serve`` exhausted ``max_ticks`` with requests still
    incomplete; the message names the stuck rids and the slots they occupy
    (or the queue they never left)."""


@dataclasses.dataclass
class QueryRequest:
    """One graph query: run ``algo`` from ``source`` to termination.

    ``arrive_round`` is the serving tick at which the request becomes
    visible to the scheduler; ``t_enqueue``/``t_done`` bracket queueing +
    service for the latency rows; ``rounds`` counts the batched rounds the
    lane rode along.  ``deadline_ticks`` bounds the ticks a request may
    spend from ENQUEUE (``enqueue_tick``, the tick the scheduler first sees
    it), so queue wait and service draw down one budget; past it the
    request is shed, ``done`` with ``reject_reason="deadline"`` and no
    labels.  ``reject_reason="overload"``: the bounded ready queue was
    full.  ``None`` deadline = run to completion."""

    rid: int
    source: int
    arrive_round: int = 0
    deadline_ticks: Optional[int] = None
    slot: int = -1
    enqueue_tick: int = -1
    t_enqueue: float = 0.0
    t_done: float = 0.0
    rounds: int = 0
    done: bool = False
    reject_reason: Optional[str] = None
    labels: Optional[np.ndarray] = None


class GraphServer:
    """Slot-based admission scheduler over the batched traversal engine:
    ``max_batch`` fixed slots, admission into free slots, one batched round
    per tick, finished lanes freed and backfilled mid-flight.  The
    ``(max_batch, n_pad)`` label and frontier lane matrices live on the
    graph's device.

    ``max_ready`` bounds the ready queue (None = unbounded): arrivals past
    it are shed newest-first.  ``straggler`` (a
    ``distributed.fault.StragglerMonitor``) observes each working tick's
    wall time; ``remesh_signals`` counts its trips."""

    def __init__(self, g, algo: str = "bfs", max_batch: int = 8,
                 damping: float = 0.85, tol: float = 1e-9,
                 max_ready: Optional[int] = None,
                 straggler: Optional[StragglerMonitor] = None):
        if algo not in ALGOS:
            raise ValueError(f"algo must be one of {ALGOS}, got {algo!r}")
        self.g = g
        self.algo = algo
        self.max_batch = max_batch
        self.max_ready = max_ready
        self.straggler = straggler
        self.deadline_evictions = 0
        self.overload_sheds = 0
        self.remesh_signals = 0
        if algo == "ppr":
            steps = ms.PprSteps(damping, tol)
            self.inf = None
        else:
            self.inf = ms.BFS_INF if algo == "bfs" else ms.SSSP_INF
            steps = ms.DistSteps(self.inf)
        self.steps = steps
        self.eng = ms.MultiSourceEngine(g, steps.sparse, steps.dense, steps.reset)
        self.free_slots = list(range(max_batch))
        self.slots: List[Optional[QueryRequest]] = [None] * max_batch
        shape = (max_batch, g.n_pad)
        if algo == "ppr":
            self.labels = (torch.zeros(shape, dtype=torch.float32, device=g.device),
                           torch.zeros(shape, dtype=torch.float32, device=g.device))
        else:
            self.labels = torch.full(shape, self.inf, dtype=torch.float32,
                                     device=g.device)
        self.fmat = torch.zeros(shape, dtype=torch.bool, device=g.device)
        self.tick_no = 0

    # -- admission -----------------------------------------------------------
    def admit(self, req: QueryRequest) -> bool:
        if not (0 <= req.source < self.g.n):
            raise ValueError(
                f"request {req.rid}: source {req.source} outside [0, {self.g.n})")
        if not self.free_slots:
            return False
        if req.enqueue_tick < 0:
            # direct admission (bypassing tick()'s ready-queue stamp)
            # starts the deadline clock here
            req.enqueue_tick = self.tick_no
        slot = self.free_slots.pop()
        req.slot = slot
        self.slots[slot] = req
        self.eng.reset_lane(self.labels, self.fmat, slot, int(req.source))
        return True

    # -- completion ----------------------------------------------------------
    def _finalize(self, slot: int) -> np.ndarray:
        if self.algo == "ppr":
            rank, resid = self.labels
            row = ms.ppr_finish(self.g, rank[slot], resid[slot])
        else:
            row = self.labels[slot]
        # a copy: the slot's row is rewritten in place by its next admission
        return row.to("cpu", copy=True).numpy()

    # -- graceful degradation ------------------------------------------------
    def _expired(self, req: QueryRequest) -> bool:
        return (req.deadline_ticks is not None and req.enqueue_tick >= 0
                and self.tick_no - req.enqueue_tick >= req.deadline_ticks)

    def _shed(self, req: QueryRequest, reason: str):
        req.done = True
        req.reject_reason = reason
        req.labels = None
        req.t_done = time.perf_counter()

    def _expire(self, ready) -> None:
        """Deadline pass, run BEFORE admission so a freed slot backfills
        within the same tick: queued requests past budget are dropped, and
        an expired lane is evicted — its rows cleared in every buffer the
        steps keep (``eng.reset_lane``: the frontier row, the label rows,
        for ppr the residual that would resurrect the frontier next round),
        its slot freed."""
        for req in [r for r in ready if self._expired(r)]:
            ready.remove(req)
            self._shed(req, "deadline")
            self.deadline_evictions += 1
        for s, req in enumerate(self.slots):
            if req is None or not self._expired(req):
                continue
            self._shed(req, "deadline")
            self.deadline_evictions += 1
            self.slots[s] = None
            self.free_slots.append(s)
            self.eng.reset_lane(self.labels, self.fmat, s)

    # -- one serving tick ----------------------------------------------------
    def tick(self, ready) -> bool:
        """Expire, shed overload, admit from ``ready`` (in place, list or
        deque), fetch once, retire, round.  Returns True while any lane did
        or may still do work."""
        t0 = time.perf_counter()
        for r in ready:
            if r.enqueue_tick < 0:
                r.enqueue_tick = self.tick_no
        self._expire(ready)
        while ready and self.free_slots:
            self.admit(ready.popleft() if hasattr(ready, "popleft")
                       else ready.pop(0))
        # the bounded ready queue, applied to what admission could not
        # place: shed newest-first (the oldest waiters keep their place)
        while self.max_ready is not None and len(ready) > self.max_ready:
            self._shed(ready.pop(), "overload")
            self.overload_sheds += 1
        total, ucount, umass, alive = self.eng.fetch(self.fmat)
        for slot, req in enumerate(self.slots):
            if req is not None and not alive[slot]:
                req.labels = self._finalize(slot)
                req.done = True
                req.t_done = time.perf_counter()
                self.slots[slot] = None
                self.free_slots.append(slot)
        if total > 0:
            self.labels, self.fmat = self.eng.round_once(
                self.labels, self.fmat, ucount, umass)
            for req in self.slots:
                if req is not None:
                    req.rounds += 1
        self.tick_no += 1
        if self.straggler is not None and total > 0:
            # per-tick wall time is the latency the deadline contract
            # prices; a straggling streak is the re-mesh cue
            if self.straggler.observe(time.perf_counter() - t0):
                self.remesh_signals += 1
        return total > 0 or any(s is not None for s in self.slots)

    def serve(self, requests: List[QueryRequest],
              max_ticks: int = 1_000_000) -> List[QueryRequest]:
        """Run every request to completion (or rejection), honouring ragged
        ``arrive_round`` schedules; freed slots backfill mid-flight.
        Raises ``ServeStuckError`` naming the stuck requests when
        ``max_ticks`` is exhausted."""
        waiting = deque(sorted(requests, key=lambda r: (r.arrive_round, r.rid)))
        ready: deque = deque()
        for _ in range(max_ticks):
            while waiting and waiting[0].arrive_round <= self.tick_no:
                req = waiting.popleft()
                req.t_enqueue = time.perf_counter()
                ready.append(req)
            busy = self.tick(ready)
            if not (waiting or ready or busy):
                break
        if not all(r.done for r in requests):
            stuck = ", ".join(
                f"rid {r.rid} ({'slot ' + str(r.slot) if r.slot >= 0 and self.slots[r.slot] is r else 'queued'})"
                for r in requests if not r.done)
            raise ServeStuckError(
                f"serve exhausted max_ticks={max_ticks} at tick "
                f"{self.tick_no} with incomplete requests: {stuck}")
        return requests


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--algo", choices=ALGOS, default="bfs")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from ..core.graph import from_coo
    rng = np.random.default_rng(0)
    n, m = 256, 2048
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    g = from_coo(src, dst, n, build_csc=True, device=args.device)

    server = GraphServer(g, algo=args.algo, max_batch=args.max_batch)
    reqs = [QueryRequest(rid=i, source=int(rng.integers(0, n)),
                         arrive_round=i // args.max_batch)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    out = server.serve(reqs)
    wall = time.perf_counter() - t0
    for r in out:
        lat = (r.t_done - r.t_enqueue) * 1e3
        print(f"req {r.rid}: src {r.source:4d}  rounds {r.rounds:3d}  "
              f"latency {lat:7.2f} ms")
    st = server.eng.stats
    print(f"served {len(out)} queries in {wall:.3f}s  "
          f"({len(out) / wall:.1f} qps) on {g.device} ({st.substrate})  "
          f"rounds={st.rounds} edges_touched={st.edges_touched}")
    print("GRAPH_SERVE_OK")


if __name__ == "__main__":
    main()

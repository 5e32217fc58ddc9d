"""Multi-source batched traversal — MS-BFS-style lane batching for serving,
as in ``repro.core.multisource``.

B concurrent queries (BFS / SSSP / PPR sources) on one resident graph share
every edge sweep.  The frontier is a (B, n_pad) bool bit-matrix — row b is
lane b's dense frontier — and ONE relax per round expands it through the
operator seam (``operators.batched_push_dense_`` / ``batched_relax_batch_``,
in place; on the card the ``edge_relax_lanes`` kernel, which packs each
vertex's lanes into one 32-bit word), so each edge slot is read once per
round instead of B times (Then et al.'s MS-BFS).  ``ms_bfs`` / ``ms_sssp``
keep two label buffers (``DistSteps``), so a sparse round touches only its
union's columns of the (B, n_pad) matrices, not all of them.

Work accounting is the serving story: ``RunStats.edges_touched`` charges
each round's sweep ONCE (the budget for a sparse union round, m for a
dense one) while ``RunStats.sources`` records B, so ``edges_touched /
sources`` is the amortized per-source cost that ``benchmarks/serving.py``
reports and the JAX package's ``ci_gate.py serve`` gates.

* **Rounds** are dispatched one per host trip by ``MultiSourceEngine``,
  with exactly one ``engine.fetch`` a round: the union frontier's ladder
  scalars and the per-lane ``alive`` flags
  (``frontier.batched_round_scalars``).  A sparse round compacts the union
  once, advances it once (merge-path) and relaxes the batch with per-lane
  slot masks; a dense round is one batched push.  Per-round dispatch is
  deliberate: the serving scheduler (``launch/graph_serve.py``) admits and
  retires lanes between rounds.
* **Sharded graphs** (``core/sharded.py``) always relax dense: each shard's
  lanes into a neutral (B, n_pad) accumulator, one full-mesh reduce, the
  merge, and the changed lanes from ``batched_updated_mask`` (out of place,
  through ``operators.batched_push_dense_``); the two-buffer in-place
  rounds are the single ``Graph``'s.  Each dense round charges
  ``batched_comm_per_relax`` to the comm counters.
* **Termination** is per lane: a finished lane's row is all-False and sends
  no message; its label row is inert (axis-1 scatters never cross lanes)
  until the scheduler reuses the slot.
* **Equality**: BFS/SSSP are min-relaxations with a unique fixpoint and
  every batched relax keeps each lane's per-round message multiset, so
  lanes are bitwise equal to B independent ``*_dd_sparse`` runs on either
  substrate.  PPR float sums are bitwise per lane under
  ``operators.set_deterministic_add(True)`` (the fixed-order tree, lane by
  lane) and allclose otherwise.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..kernels.graph_ops import lanes_beyond
from . import frontier as fr
from . import operators as ops
from .engine import RunStats, fetch
from .graph import set_at

# the per-algorithm "unreached" labels: algorithms/bfs.py's and
# algorithms/sssp.py's, for the bitwise-equality contract
FLT_MAX = torch.finfo(torch.float32).max
BFS_INF = FLT_MAX
SSSP_INF = FLT_MAX / 4


# ---------------------------------------------------------------------------
# Batched round steps (labels: a (B, n_pad) matrix or a tuple of them)
# ---------------------------------------------------------------------------


class DistSteps:
    """``ms_bfs`` / ``ms_sssp``'s round steps: a min-relaxation of (B, n_pad)
    labels from ``inf`` over two label buffers and two frontier buffers.

    Round r reads ``src_val`` from one label buffer and relaxes in place
    into the other, which holds round r-1's labels.  The two differ only
    where round r-1 changed a label — this round's frontier, whose union the
    sparse step compacts — so a sparse round reseeds the other buffer at
    the union's columns and the sentinel column only (O(|union| B)); a dense
    round reseeds it in full.  The relax itself reports the changed lanes,
    ``batched_updated_mask``'s next frontier, into the spare frontier
    buffer (all False); the round's own frontier is then cleared at the
    union's columns, which makes it all False in turn.  ``src_val`` never
    aliases the buffer relaxed into: an in-place chaotic relax would
    converge in fewer rounds than the reference and break ``RunStats``
    equality.  Both substrates run this bookkeeping; the torch one computes
    the changed mask by the plain version.

    The steps own the labels and frontier they are given and return: a
    round rewrites the buffers of the round before, so a caller keeps
    labels across rounds by copying them.  Labels that are not the last
    round's (a first round) get their spare by a whole copy; ``reset`` sets
    a lane's row in both label buffers."""

    def __init__(self, inf: float):
        self.inf = float(inf)
        # an unreached label past FLT_MAX lies beyond min's neutral, which
        # the plain version's masked slots clamp: the kernel must be told
        self.clamp = not self.inf <= FLT_MAX
        self._last = None    # (labels, frontier) the last round returned
        self._spare = None   # (labels, frontier) the next round writes into

    def _buffers(self, dist, fmat):
        last = self._last
        if last is not None and last[0] is dist and last[1] is fmat:
            return self._spare
        return dist.clone(), torch.zeros_like(fmat)

    def _done(self, dist, fmat, new, nxt):
        self._spare = (dist, fmat)
        self._last = (new, nxt)
        return new, nxt

    def _beyond(self, dist):
        return lanes_beyond(dist, "min") if self.clamp else None

    def sparse(self, g, dist, fmat, *, capacity: int, budget: int):
        new, nxt = self._buffers(dist, fmat)
        f = fr.compact(fmat.any(0), capacity, g.sentinel)
        batch = ops.advance_sparse(g, f, budget)
        ops.batched_relax_batch_(batch, dist, fmat, new, kind="min", use_weight=True,
                                 at=f.idx, reseed=True, changed=nxt,
                                 beyond=self._beyond(dist))
        # a sparse round's union holds every set column: all False again
        fmat.index_fill_(1, f.idx.long(), False)
        return self._done(dist, fmat, new, nxt)

    def dense(self, g, dist, fmat):
        new, nxt = self._buffers(dist, fmat)
        # a reseed in full finds the lanes beyond the neutral itself
        ops.batched_push_dense_(g, dist, fmat, new, kind="min", use_weight=True,
                                reseed=True, changed=nxt)
        fmat.fill_(False)
        return self._done(dist, fmat, new, nxt)

    def reset(self, labels, lane: int, source=None):
        """Lane ``lane``'s row of ``labels`` and of its spare: unreached, and
        0 at ``source`` (None: unreached everywhere)."""
        rows = [labels]
        if self._last is not None and self._last[0] is labels:
            rows.append(self._spare[0])
        for buf in rows:
            buf[lane].fill_(self.inf)
            if source is not None:
                set_at(buf[lane], source, 0.0)


class PprSteps:
    """Batched residual-push personalized-pagerank steps (labels =
    ``(rank, resid)`` lane matrices; the frontier row is ``resid > tol``).
    Op for op ``pagerank.ppr_push``, so lanes are bitwise equal to
    per-source runs under deterministic add.  Each round's pushed mass
    is relaxed in place into a zeroed accumulator: no seed to copy."""

    def __init__(self, damping: float, tol: float):
        self.damping = damping
        self.tol = tol

    def _active_mass(self, g, rank, resid, fmat):
        outdeg = torch.clamp(g.out_deg.to(torch.float32), min=1.0)
        rank = rank + torch.where(fmat, resid, 0.0)
        push_val = torch.where(fmat, self.damping * resid / outdeg, 0.0)
        return rank, push_val

    def _next(self, rank, resid, fmat, added):
        resid = torch.where(fmat, 0.0, resid) + added
        m = resid > self.tol
        m[:, -1].fill_(False)
        return (rank, resid), m

    def dense(self, g, labels, fmat):
        rank, resid = labels
        rank, push_val = self._active_mass(g, rank, resid, fmat)
        added = ops.batched_push_dense_(g, push_val, fmat, torch.zeros_like(resid),
                                        kind="add", use_weight=False)
        return self._next(rank, resid, fmat, added)

    def sparse(self, g, labels, fmat, *, capacity: int, budget: int):
        if ops.get_deterministic_add():
            # deterministic float add wants ONE canonical edge order: the
            # fixed-order tree over the full edge list associates exactly
            # like the per-source dense run, a tree over the compacted
            # batch's slots does not
            return self.dense(g, labels, fmat)
        rank, resid = labels
        rank, push_val = self._active_mass(g, rank, resid, fmat)
        f = fr.compact(fmat.any(0), capacity, g.sentinel)
        batch = ops.advance_sparse(g, f, budget)
        added = ops.batched_relax_batch_(batch, push_val, fmat, torch.zeros_like(resid),
                                         kind="add", use_weight=False, at=f.idx)
        return self._next(rank, resid, fmat, added)

    def reset(self, labels, lane: int, source=None):
        """Lane ``lane``'s rank and residual rows: 0, and a unit of residual
        at ``source`` (None: none)."""
        rank, resid = labels
        rank[lane].fill_(0.0)
        resid[lane].fill_(0.0)
        if source is not None:
            set_at(resid[lane], source, 1.0)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class MultiSourceEngine:
    """Per-round batched dispatcher over the (capacity, budget) ladder.

    ``sparse_step(g, labels, fmat, capacity=, budget=)`` and
    ``dense_step(g, labels, fmat)`` both return ``(labels, fmat)``.  The
    rung is picked from the **union** frontier's scalars and the overflow
    backstop escalates to the dense sweep (edges are never dropped).
    ``round_once`` is the scheduler's entry point: one round for scalars
    the caller already fetched, so a serving tick pays exactly one fetch;
    ``reset_lane`` admits a query into a lane or clears it, through the
    steps' ``reset(labels, lane, source)`` (every buffer they keep).
    ``stats.compiles`` counts the distinct rungs and the dense step run
    under the current substrate and det-add mode, as the reference's trace
    cache does."""

    def __init__(self, g, sparse_step: Callable, dense_step: Callable,
                 reset: Callable | None = None):
        if getattr(g, "is_tiered", False):
            raise NotImplementedError(
                "multi-source batching needs a resident CSR")
        self.g = g
        self.plain = getattr(g, "sharded_push_dense", None) is None
        self.cap_ladder = fr.ladder_capacities(g.n_pad, g.block_size)
        self.budget_ladder = fr.ladder_capacities(g.m_pad, g.block_size)
        self.sparse_cutoff = self.budget_ladder[-1] // 2
        self._sparse_fn = sparse_step
        self._dense_fn = dense_step
        self._reset = reset
        self._rungs: set = set()
        self._dense_seen = False
        self._mode = None
        self.stats = RunStats.from_graph(g)

    def _refresh_mode(self):
        mode = (ops.get_substrate(), ops.get_deterministic_add())
        if mode != self._mode:
            self._rungs = set()
            self._dense_seen = False
        self._mode = mode
        self.stats.substrate = ops.run_substrate(self.g, mode[0])

    def _sparse(self, cap: int, budget: int):
        if (cap, budget) not in self._rungs:
            self.stats.compiles += 1
            self._rungs.add((cap, budget))
        return self._sparse_fn

    def _dense(self):
        if not self._dense_seen:
            self.stats.compiles += 1
            self._dense_seen = True
        return self._dense_fn

    def reset_lane(self, labels, fmat, lane: int, source=None):
        """Admit a query from ``source`` into ``lane`` (its frontier row
        one-hot there, its label rows reset) or, with ``source=None``,
        clear the lane: in place, in every buffer the steps keep."""
        fmat[lane].fill_(False)
        if source is not None:
            set_at(fmat[lane], source, True)
        if self._reset is not None:
            self._reset(labels, lane, source)

    def fetch(self, fmat):
        """``(total, ucount, umass, alive)`` in ONE ``engine.fetch``."""
        total, ucount, umass, alive = fetch(*fr.batched_round_scalars(self.g, fmat))
        return total, ucount, umass, np.asarray(alive, dtype=bool)

    def round_once(self, labels, fmat, ucount: int, umass: int):
        """One batched round for already-fetched union scalars.  Charges
        the sweep ONCE to ``edges_touched`` whatever B is."""
        self._refresh_mode()
        g = self.g
        lanes = int(fmat.shape[0])
        self.stats.rounds += 1
        self.stats.sources = max(self.stats.sources, lanes)
        cap = fr.pick_capacity(max(ucount, 1), self.cap_ladder)
        budget = fr.pick_capacity(max(umass, 1), self.budget_ladder)
        overflow = budget < umass or cap < ucount
        if overflow and umass <= self.sparse_cutoff:
            self.stats.overflow_escalations += 1
        if not self.plain or umass > self.sparse_cutoff or overflow:
            labels, fmat = self._dense()(g, labels, fmat)
            self.stats.dense_rounds += 1
            self.stats.edges_touched += g.m
            self._add_batched_comm(lanes)
        else:
            labels, fmat = self._sparse(cap, budget)(
                g, labels, fmat, capacity=cap, budget=budget)
            self.stats.sparse_rounds += 1
            self.stats.edges_touched += budget
        return labels, fmat

    def _add_batched_comm(self, lanes: int):
        # the sharded graph's comm model: the (B, n_pad) lanes at the
        # full-mesh rate; None on a Graph
        model = getattr(self.g, "batched_comm_per_relax", None)
        if model is None:
            return
        e, b, h = model(lanes)
        self.stats.comm_elems += e
        self.stats.comm_bytes += b
        self.stats.reduce_axis_hops += h

    def run(self, labels, fmat, max_rounds: int = 10_000):
        """Run every lane to termination (one fetch per round)."""
        for _ in range(max_rounds):
            total, ucount, umass, _ = self.fetch(fmat)
            if total == 0:
                break
            labels, fmat = self.round_once(labels, fmat, ucount, umass)
        return labels, fmat


# ---------------------------------------------------------------------------
# Batched algorithm entry points
# ---------------------------------------------------------------------------


def _sources(g, sources) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sources, dtype=np.int64), device=g.device)


def ms_distances(g, sources, inf, max_rounds: int = 100_000):
    """Batched chaotic min-relaxation from B sources at once.

    Returns ``(dist, stats)``: ``dist[b]`` is bitwise the per-source
    ``*_dd_sparse`` run initialised with the same ``inf``."""
    src = _sources(g, sources)
    b = int(src.shape[0])
    dist0 = torch.full((b, g.n_pad), inf, dtype=torch.float32, device=g.device)
    dist0.scatter_(1, src.view(-1, 1), 0.0)
    fmat0 = fr.batched_from_sources(src, g.n_pad)
    steps = DistSteps(inf)
    eng = MultiSourceEngine(g, steps.sparse, steps.dense, steps.reset)
    dist, _ = eng.run(dist0, fmat0, max_rounds)
    eng.stats.sources = b
    return dist, eng.stats


def ms_bfs(g, sources, max_rounds: int = 100_000):
    """Multi-source BFS (hop counts on unit-weight builds)."""
    return ms_distances(g, sources, BFS_INF, max_rounds)


def ms_sssp(g, sources, max_rounds: int = 100_000):
    """Multi-source SSSP (weighted chaotic relaxation)."""
    return ms_distances(g, sources, SSSP_INF, max_rounds)


def ppr_finish(g, rank: torch.Tensor, resid: torch.Tensor) -> torch.Tensor:
    """A lane's ranks as ``pagerank.ppr_push`` returns them: rank + resid,
    normalised by its own sum, zero off the valid vertices."""
    row = rank + resid
    row = row / row.sum()
    return torch.where(g.valid_vertex_mask(), row, 0.0)


def ms_ppr(g, sources, damping: float = 0.85, tol: float = 1e-9,
           max_rounds: int = 10_000):
    """Batched personalized pagerank: residual push from a unit of mass on
    each lane's source, each lane normalised by its own sum
    (``pagerank.ppr_push`` is the single-source reference; bitwise per lane
    under deterministic add)."""
    src = _sources(g, sources)
    b = int(src.shape[0])
    rank0 = torch.zeros((b, g.n_pad), dtype=torch.float32, device=g.device)
    resid0 = torch.zeros_like(rank0).scatter_(1, src.view(-1, 1), 1.0)
    fmat0 = fr.batched_from_sources(src, g.n_pad)
    steps = PprSteps(damping, tol)
    eng = MultiSourceEngine(g, steps.sparse, steps.dense, steps.reset)
    (rank, resid), _ = eng.run((rank0, resid0), fmat0, max_rounds)
    # each row summed on its own, as ppr_push sums its one row
    rank = torch.stack([ppr_finish(g, r, s) for r, s in zip(rank, resid)])
    eng.stats.sources = b
    return rank, eng.stats

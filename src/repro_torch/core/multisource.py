"""Multi-source batched traversal — MS-BFS-style lane batching for serving,
as in ``repro.core.multisource``.

B concurrent queries (BFS / SSSP / PPR sources) on one resident graph share
every edge sweep.  The frontier is a (B, n_pad) bool bit-matrix — row b is
lane b's dense frontier — and ONE relax per round expands it through the
operator seam (``operators.batched_push_dense`` / ``batched_relax_batch``;
on the card the ``edge_relax_lanes`` kernel, which packs each vertex's
lanes into one 32-bit word), so each edge slot is read once per round
instead of B times (Then et al.'s MS-BFS).

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

from . import frontier as fr
from . import operators as ops
from .engine import RunStats, fetch

# the per-algorithm "unreached" labels: algorithms/bfs.py's and
# algorithms/sssp.py's, for the bitwise-equality contract
BFS_INF = torch.finfo(torch.float32).max
SSSP_INF = torch.finfo(torch.float32).max / 4


# ---------------------------------------------------------------------------
# Batched round steps (labels: a (B, n_pad) matrix or a tuple of them)
# ---------------------------------------------------------------------------


def _dist_dense_step(g, dist, fmat):
    new = ops.batched_push_dense(g, dist, fmat, dist, kind="min",
                                 use_weight=True)
    return new, ops.batched_updated_mask(dist, new)


def _dist_sparse_step(g, dist, fmat, *, capacity: int, budget: int):
    f = fr.compact(fmat.any(0), capacity, g.sentinel)
    batch = ops.advance_sparse(g, f, budget)
    new = ops.batched_relax_batch(batch, dist, fmat, dist, kind="min",
                                  use_weight=True)
    return new, ops.batched_updated_mask(dist, new)


def make_ppr_steps(damping: float, tol: float):
    """Batched residual-push personalized-pagerank steps (labels =
    ``(rank, resid)`` lane matrices; the frontier row is ``resid > tol``).
    Op for op ``pagerank.ppr_push``, so lanes are bitwise equal to
    per-source runs under deterministic add."""

    def _active_mass(g, rank, resid, fmat):
        outdeg = torch.clamp(g.out_deg.to(torch.float32), min=1.0)
        rank = rank + torch.where(fmat, resid, 0.0)
        push_val = torch.where(fmat, damping * resid / outdeg, 0.0)
        return rank, push_val

    def _next_frontier(resid):
        m = resid > tol
        m[:, -1].fill_(False)
        return m

    def dense(g, labels, fmat):
        rank, resid = labels
        rank, push_val = _active_mass(g, rank, resid, fmat)
        added = ops.batched_push_dense(g, push_val, fmat, torch.zeros_like(resid),
                                       kind="add", use_weight=False)
        resid = torch.where(fmat, 0.0, resid) + added
        return (rank, resid), _next_frontier(resid)

    def sparse(g, labels, fmat, *, capacity: int, budget: int):
        if ops.get_deterministic_add():
            # deterministic float add wants ONE canonical edge order: the
            # fixed-order tree over the full edge list associates exactly
            # like the per-source dense run, a tree over the compacted
            # batch's slots does not
            return dense(g, labels, fmat)
        rank, resid = labels
        rank, push_val = _active_mass(g, rank, resid, fmat)
        f = fr.compact(fmat.any(0), capacity, g.sentinel)
        batch = ops.advance_sparse(g, f, budget)
        added = ops.batched_relax_batch(batch, push_val, fmat,
                                        torch.zeros_like(resid), kind="add",
                                        use_weight=False)
        resid = torch.where(fmat, 0.0, resid) + added
        return (rank, resid), _next_frontier(resid)

    return sparse, dense


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
    the caller already fetched, so a serving tick pays exactly one fetch.
    ``stats.compiles`` counts the distinct rungs and the dense step run
    under the current substrate and det-add mode, as the reference's trace
    cache does."""

    def __init__(self, g, sparse_step: Callable, dense_step: Callable):
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
        # the sharded graph's comm model (ROADMAP queue 1, item 11); None
        # on a Graph
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
    eng = MultiSourceEngine(g, _dist_sparse_step, _dist_dense_step)
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
    sparse, dense = make_ppr_steps(damping, tol)
    eng = MultiSourceEngine(g, sparse, dense)
    (rank, resid), _ = eng.run((rank0, resid0), fmat0, max_rounds)
    # each row summed on its own, as ppr_push sums its one row
    rank = torch.stack([ppr_finish(g, r, s) for r, s in zip(rank, resid)])
    eng.stats.sources = b
    return rank, eng.stats

"""Round-execution engines.

The two regimes of ``repro.core.engine``:

* ``run_dense`` — ``state = step(state)`` while ``cond(state)``.  torch
  runs eagerly, so this is a Python loop with one blocking fetch of the
  condition per round (the reference fuses it into one ``while_loop``).

* ``SparseLadderEngine`` — data-driven rounds over sparse worklists along a
  (capacity, budget) rung ladder.  ``fused=True`` runs *stretches* of
  consecutive same-rung rounds: each stretch is a do-while loop that, after
  every round, evaluates the band predicate (``frontier.sparse_band`` /
  ``dense_band``) on the device and fetches it once, exiting the moment
  the host dispatcher would pick another rung or regime.  ``fused=False``
  dispatches one round at a time from the fetched ladder scalars.  Both
  produce the reference's labels and the reference's ``RunStats`` counters
  (``rounds``, ``sparse_rounds``, ``dense_rounds``, ``edges_touched``,
  ``compiles`` as distinct stretch keys, ``overflow_escalations``).  A
  stretch still fetches once per round here; capturing a rung round in a
  CUDA graph to restore the reference's one fetch per stretch is queued in
  ROADMAP.md.

Out-of-core streaming (``run_streamed``), checkpointing and fault
injection belong to later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import frontier as fr
from . import operators as ops
from .graph import Graph


@dataclasses.dataclass
class RunStats:
    rounds: int = 0
    edges_touched: int = 0
    dense_rounds: int = 0
    sparse_rounds: int = 0
    compiles: int = 0
    # sparse rung couldn't cover the frontier's edge mass → dense fallback
    overflow_escalations: int = 0
    # shards that escalated to a local dense relax (0 on a single partition)
    shard_escalations: int = 0
    # analytic cross-device communication (zero when unsharded)
    comm_elems: int = 0
    comm_bytes: int = 0
    reduce_axis_hops: int = 0
    # host→device streaming of the out-of-core path (zero when resident)
    h2d_bytes: int = 0
    shards_streamed: int = 0
    buffer_hits: int = 0
    # fault-tolerance ledger of the streamed path
    io_retries: int = 0
    checksum_failures: int = 0
    io_wait_us: int = 0
    # direction-optimizing traversal: rounds run in the pull direction
    pull_rounds: int = 0
    # concurrent source lanes the run's sweeps were amortized over
    sources: int = 1
    # execution geometry (1/"local" for an unsharded Graph)
    ndev: int = 1
    placement: str = "local"
    # what the relaxations ran on: "cuda" only when the kernels launched
    substrate: str = dataclasses.field(default_factory=ops.get_substrate)

    @classmethod
    def from_graph(cls, g, **kw) -> "RunStats":
        """Stats for a run on ``g``, with the substrate a relaxation on it
        runs.  A single resident graph has no communication to charge."""
        return cls(substrate=ops.run_substrate(g), **kw)

    def as_dict(self):
        return dataclasses.asdict(self)


def run_dense(step: Callable, state, cond: Callable, max_rounds: int):
    """``state = step(state)`` while ``cond(state)``; returns
    ``(rounds, state)``.  ``cond`` returns a device bool, fetched once per
    round."""
    rounds = 0
    while rounds < max_rounds and bool(cond(state)):
        state = step(state)
        rounds += 1
    return rounds, state


def run_host(step: Callable, state, cond: Callable, max_rounds: int):
    """Eager round loop with one blocking ``cond`` fetch per round — the
    reference's runner for graphs whose step cannot be traced.  Same
    ``(rounds, state)`` contract as ``run_dense`` (checkpointing and fault
    injection come with the out-of-core slice)."""
    return run_dense(step, state, cond, max_rounds)


def _sparse_stretch(g, labels, mask, limit, *, step, capacity, budget,
                    lo_cap, lo_budget, cutoff):
    """Consecutive (capacity, budget)-rung sparse rounds, do-while: the
    first round always runs, later ones while the band predicate holds.
    Returns ``(labels, mask, scalars, rounds)``; ``scalars`` describe the
    next round.  (A single partition never escalates a shard, so the
    step's escalation count is always 0.)"""
    k = 0
    while True:
        labels, mask, _ = step(g, labels, mask, capacity=capacity,
                               budget=budget)
        k += 1
        scalars = fr.round_scalars(g, mask)
        if k >= limit or not bool(fr.sparse_band(
                scalars, capacity, lo_cap, budget, lo_budget, cutoff)):
            return labels, mask, scalars, k


def _dense_stretch(g, labels, mask, limit, *, step, cutoff):
    """Consecutive dense-fallback rounds, do-while.  Returns
    ``(labels, mask, scalars, rounds)``."""
    k = 0
    while True:
        labels, mask = step(g, labels, mask)
        k += 1
        scalars = fr.round_scalars(g, mask)
        if k >= limit or not bool(fr.dense_band(scalars, cutoff)):
            return labels, mask, scalars, k


class SparseLadderEngine:
    """Dispatches rung stretches along a (capacity, budget) ladder
    (``fused=False`` dispatches one round at a time).  A sparse round
    charges its budget to ``edges_touched``, a dense round m."""

    def __init__(
        self,
        g: Graph,
        sparse_step: Callable,  # (g, labels, mask, capacity, budget) -> (labels, mask, esc)
        dense_step: Callable,   # (g, labels, frontier_mask) -> (labels, mask)
        fused: bool = True,
    ):
        self.fused = fused
        self._stretch_keys = set()
        self._round_keys = set()
        self.g = g
        self.cap_ladder = fr.ladder_capacities(g.n_pad, g.block_size)
        self.budget_ladder = fr.ladder_capacities(g.m_pad, g.block_size)
        # sparse rounds stop paying once they would cost about a dense one
        self.sparse_cutoff = self.budget_ladder[-1] // 2
        self._sparse_fn = sparse_step
        self._dense_fn = dense_step
        self.stats = RunStats.from_graph(g)

    def run(self, labels, mask, max_rounds: int = 10_000):
        self.stats.substrate = ops.run_substrate(self.g)
        if self.fused:
            return self._run_fused(labels, mask, max_rounds)
        return self._run_per_round(labels, mask, max_rounds)

    def _note(self, keys: set, key):
        """``compiles`` counts the distinct rung executables a run asks for
        (stretch keys when fused, rung steps per round) — the reference's
        count of jit traces, kept so the counters compare."""
        if key not in keys:
            keys.add(key)
            self.stats.compiles += 1

    def _settle(self, budget, k):
        """Fold k rounds into RunStats: dense when ``budget`` is None."""
        self.stats.rounds += k
        if budget is None:
            self.stats.dense_rounds += k
            self.stats.edges_touched += k * self.g.m
        else:
            self.stats.sparse_rounds += k
            self.stats.edges_touched += k * budget

    def _pick(self, cap_need, mass_med):
        """Host rung decision ``(cap, budget, dense?)``; counts an overflow
        escalation like the reference (unreachable while pick_capacity
        honours the ladder, kept as the backstop)."""
        cap = fr.pick_capacity(max(cap_need, 1), self.cap_ladder)
        budget = fr.pick_capacity(max(mass_med, 1), self.budget_ladder)
        overflow = budget < mass_med or cap < cap_need
        if overflow and mass_med <= self.sparse_cutoff:
            self.stats.overflow_escalations += 1
        return cap, budget, mass_med > self.sparse_cutoff or overflow

    def _run_fused(self, labels, mask, max_rounds: int):
        g = self.g
        key_mode = (ops.get_substrate(), ops.get_deterministic_add())
        scalars = fr.round_scalars(g, mask)
        rounds_left = max_rounds
        while rounds_left > 0:
            count, cap_need, mass_med, _ = scalars.tolist()
            if count == 0:
                break
            cap, budget, dense = self._pick(cap_need, mass_med)
            if dense:
                self._note(self._stretch_keys, ("dense", *key_mode))
                labels, mask, scalars, k = _dense_stretch(
                    g, labels, mask, rounds_left, step=self._dense_fn,
                    cutoff=self.sparse_cutoff)
                self._settle(None, k)
            else:
                self._note(self._stretch_keys,
                           ("sparse", cap, budget, *key_mode))
                labels, mask, scalars, k = _sparse_stretch(
                    g, labels, mask, rounds_left, step=self._sparse_fn,
                    capacity=cap, budget=budget,
                    lo_cap=fr.ladder_below(cap, self.cap_ladder),
                    lo_budget=fr.ladder_below(budget, self.budget_ladder),
                    cutoff=self.sparse_cutoff)
                self._settle(budget, k)
            rounds_left -= k
        return labels, mask

    def _run_per_round(self, labels, mask, max_rounds: int):
        g = self.g
        for _ in range(max_rounds):
            count, cap_need, mass_med, _ = fr.round_scalars(g, mask).tolist()
            if count == 0:
                break
            cap, budget, dense = self._pick(cap_need, mass_med)
            if dense:
                self._note(self._round_keys, "dense")
                labels, mask = self._dense_fn(g, labels, mask)
                self._settle(None, 1)
            else:
                self._note(self._round_keys, (cap, budget))
                labels, mask, _ = self._sparse_fn(
                    g, labels, mask, capacity=cap, budget=budget)
                self._settle(budget, 1)
        return labels, mask

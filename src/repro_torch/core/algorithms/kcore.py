"""k-core decomposition by iterative peeling, as in
``repro.core.algorithms.kcore``.

The frontier is the set of vertices removed this round.  Degrees are
int32; a removal subtracts 1 from each neighbour through an unweighted
``kind="add"`` relax, which is exact integer arithmetic, so alive masks
and core numbers are bitwise equal across substrates.

* ``kcore_peel``      — dense rounds in ``run_dense``.  ``edges_touched``
  charges the removed vertices' degree mass, not rounds × m.
* ``kcore_dd_sparse`` — the same peel through ``SparseLadderEngine``: the
  removal frontier compacts into a sparse worklist and the decrements run
  as a merge-path ``sparse_round(kind="add")``; dense fallback rounds
  charge their frontier's degree mass (``dense_cost="mass"``).
* ``core_numbers``    — coreness per vertex by peeling k = 1..k_max.

Graphs must be symmetrized; degree = out-degree of the symmetric graph.
"""

from __future__ import annotations

import functools

import torch

from .. import operators as ops
from ..engine import RunStats, SparseLadderEngine, run_dense
from ..graph import Graph


def _decrements(g: Graph, removed: torch.Tensor) -> torch.Tensor:
    """Per vertex, the number of its neighbours in ``removed`` (int32)."""
    ones = torch.ones((g.n_pad,), dtype=torch.int32, device=g.device)
    return ops.push_dense(g, ones, removed,
                          torch.zeros((g.n_pad,), dtype=torch.int32, device=g.device),
                          kind="add", use_weight=False)


def kcore_peel(g: Graph, k: int, max_rounds: int = 100_000):
    """Returns (alive_mask, stats): alive = membership in the k-core."""
    deg0 = g.out_deg.to(torch.int32)

    def step(state):
        alive, deg, work, _ = state
        remove = alive & (deg < k)
        dec = _decrements(g, remove)
        alive = alive & ~remove
        deg = deg - dec
        work = work + torch.where(remove, g.out_deg, 0).sum(dtype=torch.int32)
        return alive, deg, work, torch.any(remove)

    zero = torch.zeros((), dtype=torch.int32, device=g.device)
    rounds, (alive, _, work, _) = run_dense(
        step, (g.valid_vertex_mask(), deg0, zero, True), lambda s: s[3],
        max_rounds)
    return alive, RunStats.from_graph(
        g, relaxes=rounds, rounds=rounds, edges_touched=int(work),
        dense_rounds=rounds)


# memoised so the step for a given k is one object, as in the reference
# (whose fused engine keys its traces on the step's identity)
@functools.lru_cache(maxsize=None)
def _kcore_sparse_step(k: int):
    def step(g, state, mask, *, capacity: int, budget: int):
        alive, deg = state
        ones = torch.ones((g.n_pad,), dtype=torch.int32, device=g.device)
        dec, esc = ops.sparse_round(
            g, ones, mask, torch.zeros((g.n_pad,), dtype=torch.int32, device=g.device),
            kind="add", use_weight=False, capacity=capacity, budget=budget)
        alive = alive & ~mask
        deg = deg - dec
        # every alive sub-k vertex was removed in an earlier round, so the
        # new frontier is exactly the vertices that just dropped below k
        return (alive, deg), alive & (deg < k), esc
    return step


@functools.lru_cache(maxsize=None)
def _kcore_dense_step(k: int):
    def step(g, state, mask):
        alive, deg = state
        dec = _decrements(g, mask)
        alive = alive & ~mask
        deg = deg - dec
        return (alive, deg), alive & (deg < k)
    return step


def kcore_dd_sparse(g: Graph, k: int, max_rounds: int = 100_000,
                    fused: bool = True):
    """Peel over the sparse-worklist ladder: the frontier is this round's
    removal set.  Dense fallback rounds charge the frontier's degree mass
    (``dense_cost="mass"``), the same work convention as ``kcore_peel``.
    ``fused`` selects rung stretches (default) vs one dispatch per round."""
    alive0 = g.valid_vertex_mask()
    deg0 = g.out_deg.to(torch.int32)
    mask0 = alive0 & (deg0 < k)
    eng = SparseLadderEngine(g, _kcore_sparse_step(k), _kcore_dense_step(k),
                             dense_cost="mass", fused=fused)
    (alive, _), _ = eng.run((alive0, deg0), mask0, max_rounds)
    return alive, eng.stats


def core_numbers(g: Graph, k_max: int = 64):
    """Full coreness per vertex by peeling k = 1..k_max (reference utility).
    Each k peels to a fixpoint in a do-while loop with one fetch a round."""
    core = torch.zeros((g.n_pad,), dtype=torch.int32, device=g.device)
    alive = g.valid_vertex_mask()
    deg = g.out_deg.to(torch.int32)
    for k in range(1, k_max + 1):
        removed = True
        while removed:
            remove = alive & (deg < k)
            dec = _decrements(g, remove)
            alive, deg = alive & ~remove, deg - dec
            removed = bool(torch.any(remove))
        core = torch.where(alive, k, core)
        if not bool(torch.any(alive)):
            break
    return core


VARIANTS = {"peel": kcore_peel, "dd_sparse": kcore_dd_sparse}

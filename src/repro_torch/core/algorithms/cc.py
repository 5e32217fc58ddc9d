"""Connected components, as in ``repro.core.algorithms.cc``.

Graphs must be symmetrized (``from_coo(..., symmetrize=True)``).  Labels
are int32.

* ``cc_labelprop``     bulk-synchronous min-label propagation.
* ``cc_labelprop_sc``  label propagation + per-round shortcutting ``L = L[L]``.
* ``cc_pointer_jump``  hook + full pointer-jumping (Shiloach–Vishkin style),
                       O(log n) rounds regardless of diameter.
* ``cc_dd_sparse``     min-label flooding over the sparse-worklist ladder.
"""

from __future__ import annotations

import torch

from .. import operators as ops
from ..engine import RunStats, SparseLadderEngine, run_dense
from ..graph import Graph


def _init_labels(g: Graph):
    return torch.arange(g.n_pad, dtype=torch.int32, device=g.device)


def _dense_stats(g, rounds) -> RunStats:
    return RunStats.from_graph(g, rounds=rounds,
                               edges_touched=rounds * g.m, dense_rounds=rounds)


def _cc_dense_step(g, lab, mask):
    new = ops.push_dense(g, lab, mask, lab, kind="min", use_weight=False)
    return new, ops.updated_mask(lab, new)


def cc_labelprop(g: Graph, max_rounds: int = 100_000):
    """Data-driven dense label propagation (min-label flooding)."""
    rounds, (lab, _) = run_dense(
        lambda s: _cc_dense_step(g, *s), (_init_labels(g), g.valid_vertex_mask()),
        lambda s: torch.any(s[1]), max_rounds)
    return lab, _dense_stats(g, rounds)


def cc_labelprop_sc(g: Graph, max_rounds: int = 100_000, jumps_per_round: int = 2):
    """Label propagation with short-cutting ``L = L[L]`` after each round."""

    def step(state):
        lab, mask = state
        new = ops.push_dense(g, lab, mask, lab, kind="min", use_weight=False)
        for _ in range(jumps_per_round):
            new = new[new]
        return new, ops.updated_mask(lab, new)

    rounds, (lab, _) = run_dense(step, (_init_labels(g), g.valid_vertex_mask()),
                                 lambda s: torch.any(s[1]), max_rounds)
    return lab, _dense_stats(g, rounds)


def cc_pointer_jump(g: Graph, max_rounds: int = 10_000):
    """Hook + full pointer-jump until fixpoint.

    hook:   for every edge (u,v): parent[max(pu,pv)] <- min(pu,pv)
    jump:   parent = parent[parent] until no change (full shortcutting)
    """

    def full_jump(par):
        while True:
            q = par[par]
            if not bool(torch.any(q != par)):
                return q
            par = q

    def step(state):
        par, _ = state
        pu = par[g.src_idx]
        pv = par[g.col_idx]
        # the hook scatters to a label-derived destination: the plain
        # scatter_reduce of the kernel layer, not an edge-relax kernel
        hooked = ops.scatter_reduce(torch.maximum(pu, pv), torch.minimum(pu, pv),
                                    par, "min")
        jumped = full_jump(hooked)
        return jumped, torch.any(jumped != par)

    rounds, (par, _) = run_dense(step, (_init_labels(g), True),
                                 lambda s: s[1], max_rounds)
    return par, RunStats.from_graph(g, rounds=rounds,
                                    edges_touched=rounds * g.m,
                                    dense_rounds=rounds)


def _cc_sparse_step(g, lab, mask, *, capacity: int, budget: int):
    new, esc = ops.sparse_round(g, lab, mask, lab, kind="min",
                                use_weight=False, capacity=capacity,
                                budget=budget)
    return new, ops.updated_mask(lab, new), esc


def cc_dd_sparse(g: Graph, max_rounds: int = 100_000, fused: bool = True):
    """Min-label flooding over the sparse-worklist ladder: starts dense
    (every vertex active) and drops to sparse budgets as the flood settles."""
    eng = SparseLadderEngine(g, _cc_sparse_step, _cc_dense_step, fused=fused)
    lab, _ = eng.run(_init_labels(g), g.valid_vertex_mask(), max_rounds)
    return lab, eng.stats


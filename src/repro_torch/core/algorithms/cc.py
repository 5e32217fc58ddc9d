"""Connected components, as in ``repro.core.algorithms.cc``.

Graphs must be symmetrized (``from_coo(..., symmetrize=True)``).  Labels
are int32.

* ``cc_labelprop``     bulk-synchronous min-label propagation.
* ``cc_labelprop_sc``  label propagation + per-round shortcutting ``L = L[L]``.
* ``cc_pointer_jump``  hook + full pointer-jumping (Shiloach–Vishkin style),
                       O(log n) rounds regardless of diameter.
* ``cc_dd_sparse``     min-label flooding over the sparse-worklist ladder.
* ``cc_incremental``   re-converges after a ``dynamic.DeltaBatch``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontier as fr
from .. import operators as ops
from ..engine import RunStats, SparseLadderEngine, run_dense, run_host
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

    # the full jump reads the device every pass: eager rounds
    rounds, (par, _) = run_host(step, (_init_labels(g), True),
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


def cc_incremental(g, labels, delta, max_rounds: int = 100_000,
                   fused: bool = True):
    """Re-converge CC labels after a ``dynamic.DeltaBatch`` applied with
    ``symmetrize=True`` (both endpoints of every insert are dirty).
    Inserts only merge components, so the min flood restarts from the
    dirty endpoints alone; its fixed point is unique, so the result is
    bitwise equal to a from-scratch ``cc_dd_sparse`` on the updated
    container."""
    mask0 = fr.dense_from_indices(delta.dirty.astype(np.int64), g.n_pad,
                                  device=g.device).mask
    eng = SparseLadderEngine(g, _cc_sparse_step, _cc_dense_step, fused=fused)
    lab, _ = eng.run(labels, mask0, max_rounds)
    return lab, eng.stats



VARIANTS = {
    "labelprop": cc_labelprop,
    "labelprop_sc": cc_labelprop_sc,
    "pointer_jump": cc_pointer_jump,
    "dd_sparse": cc_dd_sparse,
}

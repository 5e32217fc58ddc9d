"""Single-source shortest paths, as in ``repro.core.algorithms.sssp``.

* ``sssp_bellman_ford`` topology-driven rounds over all edges.
* ``sssp_dd_dense``     data-driven with a dense worklist.
* ``sssp_dd_sparse``    chaotic relaxation over the sparse ladder.
* ``sssp_batch``        ``sssp_dd_sparse`` from B sources at once
                        (core/multisource.py).
* ``sssp_delta``        delta-stepping over priority buckets: light edges
                        relaxed until the bucket drains, then one heavy pass.
"""

from __future__ import annotations

import torch

from .. import operators as ops
from ..engine import RunStats, SparseLadderEngine, run_dense, run_host
from ..graph import Graph, set_at
from .bfs import _source_mask

INF = torch.finfo(torch.float32).max / 4


def _init_dist(g: Graph, src: int):
    return set_at(g.vertex_full(INF, torch.float32), src, 0.0)


def _dense_stats(g, rounds) -> RunStats:
    return RunStats.from_graph(g, relaxes=rounds, rounds=rounds,
                               edges_touched=rounds * g.m, dense_rounds=rounds)


def sssp_bellman_ford(g: Graph, src: int, max_rounds: int = 100_000):
    all_active = g.valid_vertex_mask()

    def step(state):
        dist, _ = state
        new = ops.push_dense(g, dist, all_active, dist, kind="min")
        return new, torch.any(new != dist)

    rounds, (dist, _) = run_dense(step, (_init_dist(g, src), True),
                                  lambda s: s[1], max_rounds)
    return dist, _dense_stats(g, rounds)


def _sssp_dense_step(g, dist, mask):
    new = ops.push_dense(g, dist, mask, dist, kind="min")
    return new, ops.updated_mask(dist, new)


def sssp_dd_dense(g: Graph, src: int, max_rounds: int = 100_000):
    rounds, (dist, _) = run_dense(
        lambda s: _sssp_dense_step(g, *s),
        (_init_dist(g, src), _source_mask(g, src)),
        lambda s: torch.any(s[1]), max_rounds)
    return dist, _dense_stats(g, rounds)


def _sssp_sparse_step(g, dist, mask, *, capacity: int, budget: int):
    new, esc = ops.sparse_round(g, dist, mask, dist, kind="min",
                                capacity=capacity, budget=budget)
    return new, ops.updated_mask(dist, new), esc


def sssp_dd_sparse(g: Graph, src: int, max_rounds: int = 100_000,
                   fused: bool = True):
    """Chaotic relaxation over the sparse ladder (no priority order)."""
    eng = SparseLadderEngine(g, _sssp_sparse_step, _sssp_dense_step,
                             fused=fused)
    dist, _ = eng.run(_init_dist(g, src), _source_mask(g, src), max_rounds)
    return dist, eng.stats


def sssp_batch(g: Graph, sources, max_rounds: int = 100_000):
    """Multi-source SSSP: B concurrent sources share every edge sweep
    (``core/multisource.py``).  Row b is bitwise equal to
    ``sssp_dd_sparse(g, sources[b])``'s labels."""
    from .. import multisource as ms
    return ms.ms_distances(g, sources, INF, max_rounds)


def sssp_delta(g: Graph, src: int, delta: float = 4.0,
               max_outer: int = 100_000, max_inner: int = 1_000):
    """Delta-stepping with light/heavy split (dense masks).

    State: dist, pending (touched since last processed), bucket index.
    The bucket bounds are float32 arithmetic on the device, as in the
    reference: lo = f32(bidx) * delta, hi = lo + delta, and the next bucket
    floor(min / delta)."""
    valid = g.valid_vertex_mask()
    light = g.edge_w <= delta

    def relax(dist, mask, edge_sel):
        # per-edge activation (light/heavy × active source)
        return ops.relax_edges(g, dist, mask[g.src_idx] & edge_sel, dist,
                               kind="min", use_weight=True)

    def outer_body(state):
        dist, pending, bidx, inner_total = state
        lo = bidx.to(torch.float32) * delta
        hi = lo + delta

        def in_bucket(dist, pending):
            return pending & (dist >= lo) & (dist < hi)

        # --- inner loop: drain the bucket over light edges
        it = 0
        while it < max_inner and bool(torch.any(in_bucket(dist, pending))):
            active = in_bucket(dist, pending)
            new = relax(dist, active, light)
            pending = (pending & ~active) | ops.updated_mask(dist, new)
            dist = new
            it += 1

        # --- settle the bucket: one heavy-edge pass from everything in it
        settled = (dist >= lo) & (dist < hi) & valid
        new = relax(dist, settled, ~light)
        pending = pending | ops.updated_mask(dist, new)
        dist = new

        # --- advance to the next non-empty bucket
        nxt = torch.where(pending & (dist < INF), dist, INF)
        nb = torch.floor(nxt.min() / delta).to(torch.int32)
        nb = torch.maximum(nb, bidx + 1)
        return dist, pending, nb, inner_total + it

    def outer_cond(state):
        dist, pending, _, _ = state
        return torch.any(pending & (dist < INF))

    bidx0 = torch.zeros((), dtype=torch.int32, device=g.device)
    # the bucket drain reads the device every inner round: eager rounds
    rounds, (dist, _, _, inner_total) = run_host(
        outer_body, (_init_dist(g, src), _source_mask(g, src), bidx0, 0),
        outer_cond, max_outer)
    return dist, RunStats.from_graph(g, rounds=rounds,
                                     edges_touched=inner_total * g.m,
                                     dense_rounds=inner_total)



VARIANTS = {
    "bellman_ford": sssp_bellman_ford,
    "dd_dense": sssp_dd_dense,
    "dd_sparse": sssp_dd_sparse,
    "delta": sssp_delta,
}

"""Breadth-first search — the paper's four implementation classes, as in
``repro.core.algorithms.bfs`` on resident graphs.

* ``bfs_topo``      topology-driven bulk-synchronous (Bellman-Ford-on-hops).
* ``bfs_dd_dense``  data-driven, dense bitmap worklist.
* ``bfs_dd_sparse`` data-driven, sparse worklist via the capacity ladder.
* ``bfs_dirop``     direction-optimizing (Beamer).

Distances are float32; the relax carries the graph's edge weights.
"""

from __future__ import annotations

import torch

from .. import frontier as fr
from .. import operators as ops
from ..engine import RunStats, SparseLadderEngine, run_dense
from ..graph import Graph

INF = torch.finfo(torch.float32).max


def _init_dist(g: Graph, src: int):
    dist = g.vertex_full(INF, torch.float32)
    dist[src] = 0.0
    return dist


def _source_mask(g: Graph, src: int):
    return fr.dense_from_indices([src], g.n_pad, device=g.device).mask


def _dense_stats(g, rounds) -> RunStats:
    return RunStats.from_graph(g, rounds=rounds,
                               dense_rounds=rounds, edges_touched=rounds * g.m)


def bfs_topo(g: Graph, src: int, max_rounds: int = 100_000):
    """Every round relaxes *all* edges (operator applied to every vertex)."""
    valid = g.valid_vertex_mask()

    def step(state):
        dist, _ = state
        new = ops.push_dense(g, dist, valid, dist, kind="min", use_weight=True)
        return new, torch.any(new != dist)

    rounds, (dist, _) = run_dense(step, (_init_dist(g, src), True),
                                  lambda s: s[1], max_rounds)
    return dist, _dense_stats(g, rounds)


def _dd_step(g, state):
    dist, mask = state
    new = ops.push_dense(g, dist, mask, dist, kind="min", use_weight=True)
    return new, ops.updated_mask(dist, new)


def bfs_dd_dense(g: Graph, src: int, max_rounds: int = 100_000):
    """Data-driven: only vertices whose label changed last round push."""
    rounds, (dist, _) = run_dense(
        lambda s: _dd_step(g, s), (_init_dist(g, src), _source_mask(g, src)),
        lambda s: torch.any(s[1]), max_rounds)
    return dist, _dense_stats(g, rounds)


def _sparse_step(g, dist, mask, *, capacity: int, budget: int):
    new, esc = ops.sparse_round(g, dist, mask, dist, kind="min",
                                use_weight=True, capacity=capacity,
                                budget=budget)
    return new, ops.updated_mask(dist, new), esc


def _dense_step(g, dist, mask):
    return _dd_step(g, (dist, mask))


def bfs_dd_sparse(g: Graph, src: int, max_rounds: int = 100_000,
                  fused: bool = True):
    """Data-driven over the sparse-worklist ladder (the paper's Galois
    class).  ``fused`` selects rung stretches (default) vs one dispatch per
    round — identical labels and RunStats either way."""
    eng = SparseLadderEngine(g, _sparse_step, _dense_step, fused=fused)
    dist, _ = eng.run(_init_dist(g, src), _source_mask(g, src), max_rounds)
    return dist, eng.stats


def bfs_dirop(g: Graph, src: int, max_rounds: int = 100_000,
              alpha: float = 14.0, beta: float = 24.0):
    """Direction-optimizing BFS (needs CSC).  A push round charges m to
    ``edges_touched``, a pull round the in-degree mass of the unvisited
    vertices; the α/β switch accumulates the mass of the direction run, in
    float32 as the reference does."""
    if not g.has_csc:
        raise ValueError("bfs_dirop requires build_csc=True")
    in_deg = g.in_deg
    total_edges = torch.tensor(g.m, dtype=torch.float32, device=g.device)
    zero_f = torch.zeros((), dtype=torch.float32, device=g.device)

    def step(state):
        dist, mask, pull, visited_edges, work, pulls = state
        fcount = mask.sum(dtype=torch.int32).to(torch.float32)
        out_mass = torch.where(mask, g.out_deg, 0).sum(dtype=torch.int32).to(torch.float32)
        in_mass = torch.where(mask, in_deg, 0).sum(dtype=torch.int32).to(torch.float32)
        unvisited = torch.clamp(total_edges - visited_edges, min=0.0)
        pull = ops.direction_choice(g, out_mass, unvisited, fcount, pull,
                                    alpha, beta)
        scan_mass = torch.where(dist == INF, in_deg, 0).sum(dtype=torch.int32)
        if bool(pull):
            new = ops.pull_dense(g, dist, mask, dist, kind="min", use_weight=True)
            work = work + int(scan_mass)
        else:
            new = ops.push_dense(g, dist, mask, dist, kind="min", use_weight=True)
            work = work + g.m
        return (new, ops.updated_mask(dist, new), pull,
                visited_edges + torch.where(pull, in_mass, out_mass),
                work, pulls + int(bool(pull)))

    state0 = (_init_dist(g, src), _source_mask(g, src),
              torch.zeros((), dtype=torch.bool, device=g.device), zero_f, 0, 0)
    rounds, (dist, _, _, _, work, pulls) = run_dense(
        step, state0, lambda s: torch.any(s[1]), max_rounds)
    stats = RunStats.from_graph(g, rounds=rounds,
                                edges_touched=work, dense_rounds=rounds,
                                pull_rounds=pulls)
    return dist, stats


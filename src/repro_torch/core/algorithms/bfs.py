"""Breadth-first search — the paper's four implementation classes, as in
``repro.core.algorithms.bfs``, on resident and tiered (out-of-core) graphs.

* ``bfs_topo``      topology-driven bulk-synchronous (Bellman-Ford-on-hops).
* ``bfs_dd_dense``  data-driven, dense bitmap worklist.
* ``bfs_dd_sparse`` data-driven, sparse worklist via the capacity ladder.
* ``bfs_dirop``     direction-optimizing (Beamer).
* ``bfs_incremental`` re-converges after a ``dynamic.DeltaBatch``.
* ``bfs_batch``     ``bfs_dd_sparse`` from B sources at once
                    (core/multisource.py).

Distances are float32; the relax carries the graph's edge weights.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import frontier as fr
from .. import operators as ops
from ..engine import (RunStats, SparseLadderEngine, _mask_active, _mask_cond,
                      fetch, run_dense, run_host, run_streamed)
from ..graph import Graph, set_at

INF = torch.finfo(torch.float32).max


def _init_dist(g: Graph, src: int):
    return set_at(g.vertex_full(INF, torch.float32), src, 0.0)


def _source_mask(g: Graph, src: int):
    """``dense_from_indices([src])``'s mask, set on the device (no copy
    from the host)."""
    mask = torch.zeros((g.n_pad,), dtype=torch.bool, device=g.device)
    set_at(mask, src, True)
    return set_at(mask, g.n_pad - 1, False)  # never activate the sentinel


def _io_snapshot(g):
    return g.io.snapshot() if getattr(g, "is_tiered", False) else None


def _dense_stats(g, rounds, io0=None) -> RunStats:
    """Stats for ``rounds`` dense rounds; on a tiered graph the edge and
    h2d accounting is the stream counters' delta since ``io0``."""
    stats = RunStats.from_graph(g, relaxes=rounds, rounds=rounds, dense_rounds=rounds)
    if io0 is not None:
        g.io.fold_delta(stats, io0)
    else:
        stats.edges_touched = rounds * g.m
    return stats


# Steps that take the graph container as an argument: run_streamed hands
# them the TieredGraph (eager rounds) or a StagedShards set (a stretch).


def _topo_step(gr, state):
    dist, _ = state
    new = ops.push_dense(gr, dist, gr.valid_vertex_mask(), dist, kind="min",
                         use_weight=True)
    return new, torch.any(new != dist)


def _topo_cond(state):
    return state[1]


def _topo_active(gr, state):
    return gr.valid_vertex_mask()


def bfs_topo(g: Graph, src: int, max_rounds: int = 100_000):
    """Every round relaxes *all* edges (operator applied to every vertex)."""
    state0 = (_init_dist(g, src), True)
    io0 = _io_snapshot(g)
    if io0 is not None:
        rounds, (dist, _) = run_streamed(g, _topo_step, state0, _topo_cond,
                                         _topo_active, max_rounds)
    else:
        rounds, (dist, _) = run_dense(lambda s: _topo_step(g, s), state0,
                                      _topo_cond, max_rounds)
    return dist, _dense_stats(g, rounds, io0)


def _dd_step(g, state):
    dist, mask = state
    new = ops.push_dense(g, dist, mask, dist, kind="min", use_weight=True)
    return new, ops.updated_mask(dist, new)


def bfs_dd_dense(g: Graph, src: int, max_rounds: int = 100_000):
    """Data-driven: only vertices whose label changed last round push."""
    state0 = (_init_dist(g, src), _source_mask(g, src))
    io0 = _io_snapshot(g)
    if io0 is not None:
        rounds, (dist, _) = run_streamed(g, _dd_step, state0, _mask_cond,
                                         _mask_active, max_rounds)
    else:
        rounds, (dist, _) = run_dense(lambda s: _dd_step(g, s), state0,
                                      _mask_cond, max_rounds)
    return dist, _dense_stats(g, rounds, io0)


def _sparse_step(g, dist, mask, *, capacity: int, budget: int):
    new, esc = ops.sparse_round(g, dist, mask, dist, kind="min",
                                use_weight=True, capacity=capacity,
                                budget=budget)
    return new, ops.updated_mask(dist, new), esc


def _dense_step(g, dist, mask):
    return _dd_step(g, (dist, mask))


def bfs_dd_sparse(g: Graph, src: int, max_rounds: int = 100_000,
                  fused: bool = True, checkpointer=None):
    """Data-driven over the sparse-worklist ladder (the paper's Galois
    class).  ``fused`` selects rung stretches (default) vs one dispatch per
    round — identical labels and RunStats either way.  ``checkpointer`` (a
    ``checkpoint.RunCheckpointer``) snapshots the (dist, frontier) state
    and resumes an interrupted run bitwise."""
    eng = SparseLadderEngine(g, _sparse_step, _dense_step, fused=fused)
    dist, _ = eng.run(_init_dist(g, src), _source_mask(g, src), max_rounds,
                      checkpointer=checkpointer)
    return dist, eng.stats


def bfs_incremental(g, dist, delta, max_rounds: int = 100_000,
                    fused: bool = True, checkpointer=None):
    """Re-converge BFS distances after a ``dynamic.DeltaBatch``.  Inserts
    only shorten paths, so ``dist`` stays an upper bound and the min-relax
    fixed point is reached from the batch's dirty sources that are already
    reached; the fixed point is unique and every relax makes the same
    ``dist[src] + w`` message, so the result is bitwise equal to a
    from-scratch ``bfs_dd_sparse`` on the updated container."""
    dirty = fr.dense_from_indices(delta.dirty.astype(np.int64), g.n_pad,
                                  device=g.device).mask
    mask0 = dirty & (dist != INF)
    eng = SparseLadderEngine(g, _sparse_step, _dense_step, fused=fused)
    dist, _ = eng.run(dist, mask0, max_rounds, checkpointer=checkpointer)
    return dist, eng.stats


def _in_degrees(g) -> torch.Tensor:
    """(n_pad,) in-degree from the CSC mirror: a ``Graph``'s ``in_deg``;
    a sharded graph's in-edge shards carry none, so their flat
    destinations are counted once (padding names the sentinel, which is
    cleared)."""
    in_deg = getattr(g, "in_deg", None)
    if in_deg is not None:
        return in_deg
    counted = torch.bincount(g.in_dst.reshape(-1), minlength=g.n_pad).to(torch.int32)
    return set_at(counted, g.sentinel, 0)


def _dirop_scalars(g, dist, mask, pull_prev, visited, *, alpha, beta):
    """Everything the streamed dirop's host loop needs for one round, in
    one device computation fetched in a single transfer:
    ``(frontier_count, pull?, direction_mass, scan_mass, live_shards)``.
    The α/β decision is computed on the device with the resident run's
    float32 expressions, so the streamed run takes bitwise the same
    direction switches."""
    fcount_i = mask.sum(dtype=torch.int32)
    fcount = fcount_i.to(torch.float32)
    out_mass = torch.where(mask, g.out_deg, 0).sum(dtype=torch.int32).to(torch.float32)
    in_mass = torch.where(mask, g.in_deg, 0).sum(dtype=torch.int32).to(torch.float32)
    total = torch.full((), g.m, dtype=torch.float32, device=g.device)
    unvisited = torch.clamp(total - visited, min=0.0)
    pull = ops.direction_choice(g, out_mass, unvisited, fcount, pull_prev,
                                alpha, beta)
    scan_mass = torch.where(dist == INF, g.in_deg, 0).sum(dtype=torch.int32)
    _, live = g.round_live(mask)
    return fcount_i, pull, torch.where(pull, in_mass, out_mass), scan_mass, live


def _bfs_dirop_streamed(g, src: int, max_rounds: int, alpha: float,
                        beta: float):
    """Direction-optimizing BFS out of core: push rounds stream the live
    CSR shards, pull rounds the whole CSC mirror, through the same pool.
    One fetch per round (``_dirop_scalars``) covers termination, the α/β
    switch, the direction mass, the pull round's scan mass and the push
    schedule.  ``visited`` accumulates on the host in float32, the same
    IEEE adds the resident loop makes, so switches, labels and the work
    convention (push = m, pull = unvisited in-degree mass) match the
    resident ``bfs_dirop``."""
    dist = _init_dist(g, src)
    mask = _source_mask(g, src)
    io0 = g.io.snapshot()
    visited = np.float32(0.0)
    pull_prev = False
    work = pulls = rounds = 0
    while rounds < max_rounds:
        fcount, pull, mass_inc, scan_mass, live = fetch(*_dirop_scalars(
            g, dist, mask,
            torch.full((), pull_prev, device=g.device),
            torch.full((), float(visited), dtype=torch.float32, device=g.device),
            alpha=alpha, beta=beta))
        if fcount == 0:
            break
        if pull:
            new = ops.pull_dense(g, dist, mask, dist, kind="min", use_weight=True)
            work += scan_mass
        else:
            g.set_live_hint(np.asarray(live, dtype=bool))
            new = ops.push_dense(g, dist, mask, dist, kind="min", use_weight=True)
            work += g.m
        dist, mask = new, ops.updated_mask(dist, new)
        visited = np.float32(visited + np.float32(mass_inc))
        pull_prev = pull
        pulls += int(pull)
        rounds += 1
    stats = RunStats.from_graph(g, relaxes=rounds, rounds=rounds, edges_touched=work,
                                dense_rounds=rounds, pull_rounds=pulls)
    # edges_touched follows Beamer's work convention, not relaxed slots
    g.io.fold_delta(stats, io0, include_edges=False)
    return dist, stats


def bfs_dirop(g: Graph, src: int, max_rounds: int = 100_000,
              alpha: float = 14.0, beta: float = 24.0):
    """Direction-optimizing BFS (needs CSC).  A push round charges m to
    ``edges_touched``, a pull round the in-degree mass of the unvisited
    vertices; the α/β switch accumulates the mass of the direction run, in
    float32 as the reference does.  Each round reads its direction on the
    host, so the rounds run in ``run_host``."""
    if not g.has_csc:
        raise ValueError("bfs_dirop requires build_csc=True")
    if getattr(g, "is_tiered", False):
        return _bfs_dirop_streamed(g, src, max_rounds, alpha, beta)
    in_deg = _in_degrees(g)
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
    rounds, (dist, _, _, _, work, pulls) = run_host(
        step, state0, lambda s: torch.any(s[1]), max_rounds)
    stats = RunStats.from_graph(g, relaxes=rounds, rounds=rounds, edges_touched=work,
                                dense_rounds=rounds, pull_rounds=pulls)
    return dist, stats


def bfs_batch(g: Graph, sources, max_rounds: int = 100_000):
    """Multi-source BFS: B concurrent sources share every edge sweep
    (``core/multisource.py``).  Row b is bitwise equal to
    ``bfs_dd_sparse(g, sources[b])``'s labels."""
    from .. import multisource as ms
    return ms.ms_distances(g, sources, INF, max_rounds)


VARIANTS = {
    "topo": bfs_topo,
    "dd_dense": bfs_dd_dense,
    "dd_sparse": bfs_dd_sparse,
    "dirop": bfs_dirop,
}

"""Single-source betweenness centrality (Brandes), unweighted, as in
``repro.core.algorithms.bc``.

Forward sweep: BFS levels + shortest-path counts sigma, level by level.
Backward sweep: dependency accumulation from the deepest level back to the
source.  Every edge scatter is a ``push_dense`` of the operator seam,
operation for operation the reference's:

* level discovery: ``kind="min"`` carrying ``dist + 1`` (weight-free, so
  bc is a hop-count sweep on weighted graphs too);
* sigma: ``kind="add"`` of sigma from the current level, accepted only at
  vertices the min-relax just discovered (``new_dist == lvl + 1``);
* backward: ``(1 + delta[v]) / sigma[v]`` pushed along reversed edges
  (``reverse=True``), accepted only at vertices on the current level, then
  scaled by sigma[u].

The reference's ``lax.while_loop``s become Python loops with the same
conditions: the forward one fetches its ``changed`` flag once a round; the
backward one runs a known number of rounds and fetches nothing.  Float
sums follow the substrate's order (allclose); under
``operators.set_deterministic_add(True)`` both run the fixed-order tree
and the scores are bitwise the reference's.
"""

from __future__ import annotations

import torch

from .. import operators as ops
from ..engine import RunStats
from ..graph import Graph, set_at

INF = torch.finfo(torch.float32).max / 4


def brandes_forward(g: Graph, src: int, max_rounds: int = 100_000):
    """The forward sweep: returns ``(levels, dist, sigma)``; ``levels`` is
    the deepest discovered level + 1 (the number of forward rounds)."""
    zeros = torch.zeros((g.n_pad,), dtype=torch.float32, device=g.device)
    dist = torch.full((g.n_pad,), INF, dtype=torch.float32, device=g.device)
    set_at(dist, src, 0.0)
    sigma = zeros.clone()
    set_at(sigma, src, 1.0)
    lvl, changed = 0, True
    while changed and lvl < max_rounds:
        lvlf = float(lvl)
        on_lvl = dist == lvlf
        new_dist = ops.push_dense(g, dist + 1.0, on_lvl, dist, kind="min",
                                  use_weight=False)
        inc = ops.push_dense(g, sigma, on_lvl, zeros, kind="add",
                             use_weight=False)
        sigma = sigma + torch.where(new_dist == lvlf + 1.0, inc, 0.0)
        changed = bool(torch.any(new_dist != dist))
        dist = new_dist
        lvl += 1
    return lvl, dist, sigma


def bc_brandes(g: Graph, src: int, max_rounds: int = 100_000):
    """Returns (bc scores (n_pad,) float32, stats)."""
    max_lvl, dist, sigma = brandes_forward(g, src, max_rounds)
    zeros = torch.zeros((g.n_pad,), dtype=torch.float32, device=g.device)
    delta = zeros
    for lvl in range(max_lvl - 1, -1, -1):
        lvlf = float(lvl)
        on_next = dist == lvlf + 1.0
        # sigma >= 1 wherever on_next holds; the clamp only touches masked slots
        val = torch.where(on_next, (1.0 + delta) / torch.clamp(sigma, min=1.0), 0.0)
        inc = ops.push_dense(g, val, on_next, zeros, kind="add",
                             use_weight=False, reverse=True)
        delta = delta + torch.where(dist == lvlf, sigma * inc, 0.0)
    bc = delta.clone()
    set_at(bc, src, 0.0)

    # each forward round is two full-edge relaxes (discovery min + sigma
    # add), each backward round one reversed relax, charged at the
    # reverse-safe reducer's comm rate (a 2-D cut runs it full-mesh)
    fwd_rounds = bwd_rounds = max_lvl
    stats = RunStats.from_graph(
        g, relaxes=2 * fwd_rounds, rounds=fwd_rounds + bwd_rounds,
        edges_touched=(2 * fwd_rounds + bwd_rounds) * g.m,
        dense_rounds=fwd_rounds + bwd_rounds)
    stats.add_comm(g, relaxes=bwd_rounds, reverse=True)
    return bc, stats


VARIANTS = {"brandes": bc_brandes}

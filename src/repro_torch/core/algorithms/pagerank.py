"""PageRank — topology-driven pull vs data-driven residual push, as in
``repro.core.algorithms.pagerank`` on resident graphs.

* ``pr_pull``  power-iteration pull (needs CSC); dangling mass is spread
               uniformly.
* ``pr_push``  residual push (PR-Delta): only vertices with residual > tol
               push.  Converges to the same fixpoint.
* ``ppr_push`` personalized PageRank by residual push from one source.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import operators as ops
from ..engine import RunStats, run_dense
from ..graph import Graph


class PRState(NamedTuple):
    """Un-normalised (rank, residual) pair; the push invariant
    ``resid = (1-d)·1 − rank + d·P rank`` holds for it at every point."""

    rank: torch.Tensor
    resid: torch.Tensor


def _dense_stats(g, rounds) -> RunStats:
    return RunStats.from_graph(g, rounds=rounds,
                               edges_touched=rounds * g.m, dense_rounds=rounds)


def pr_pull(g: Graph, damping: float = 0.85, tol: float = 1e-6,
            max_iters: int = 100):
    """Power-iteration pull PageRank."""
    if not g.has_csc:
        raise ValueError("pr_pull requires build_csc=True")
    # n is a float32 tensor so that every scalar expression below rounds
    # in float32, as the reference's does
    n = torch.tensor(float(g.n), dtype=torch.float32, device=g.device)
    valid = g.valid_vertex_mask()
    outdeg = torch.clamp(g.out_deg.to(torch.float32), min=1.0)
    dangling = valid & (g.out_deg == 0)
    rank0 = torch.where(valid, 1.0 / n, 0.0)

    def step(state):
        rank, _ = state
        contrib = torch.where(valid, rank / outdeg, 0.0)
        pulled = ops.pull_dense(g, contrib, valid, torch.zeros_like(rank),
                                kind="add")
        dmass = torch.where(dangling, rank, 0.0).sum()
        new = torch.where(valid, (1.0 - damping) / n + damping * (pulled + dmass / n),
                          0.0)
        return new, torch.abs(new - rank).sum()

    rounds, (rank, _) = run_dense(step, (rank0, float("inf")),
                                  lambda s: s[1] > tol, max_iters)
    return rank, _dense_stats(g, rounds)


def _pr_step(g, damping, tol):
    outdeg = torch.clamp(g.out_deg.to(torch.float32), min=1.0)

    def step(state):
        rank, resid = state
        active = resid > tol
        rank = rank + torch.where(active, resid, 0.0)
        push_val = torch.where(active, damping * resid / outdeg, 0.0)
        added = ops.push_dense(g, push_val, active, torch.zeros_like(resid),
                               kind="add", use_weight=False)
        return rank, torch.where(active, 0.0, resid) + added

    return step


def _pr_push_raw(g, damping, tol, max_iters, state0=None):
    """Run the residual-push iteration to convergence from ``state0`` (or
    the cold uniform start); returns the raw ``(rank, resid, rounds)``."""
    if state0 is None:
        rank0 = torch.zeros((g.n_pad,), dtype=torch.float32, device=g.device)
        resid0 = torch.where(g.valid_vertex_mask(), 1.0 - damping, 0.0)
    else:
        rank0, resid0 = state0
    rounds, (rank, resid) = run_dense(
        _pr_step(g, damping, tol), (rank0, resid0),
        lambda s: torch.any(s[1] > tol), max_iters)
    return rank, resid, rounds


def pr_push(g: Graph, damping: float = 0.85, tol: float = 1e-9,
            max_iters: int = 10_000):
    """Residual push PageRank, normalised at the end to match ``pr_pull``."""
    rank, resid, rounds = _pr_push_raw(g, damping, tol, max_iters)
    rank = rank + resid  # fold in the leftover residual
    rank = torch.where(g.valid_vertex_mask(), rank / rank.sum(), 0.0)
    return rank, _dense_stats(g, rounds)


def ppr_push(g: Graph, src: int, damping: float = 0.85, tol: float = 1e-9,
             max_iters: int = 10_000):
    """Personalized PageRank by residual push from a single source."""
    valid = g.valid_vertex_mask()
    outdeg = torch.clamp(g.out_deg.to(torch.float32), min=1.0)
    rank0 = torch.zeros((g.n_pad,), dtype=torch.float32, device=g.device)
    resid0 = rank0.clone()
    resid0[src] = 1.0

    def step(state):
        rank, resid = state
        active = resid > tol
        active[-1] = False
        rank = rank + torch.where(active, resid, 0.0)
        push_val = torch.where(active, damping * resid / outdeg, 0.0)
        added = ops.push_dense(g, push_val, active, torch.zeros_like(resid),
                               kind="add", use_weight=False)
        return rank, torch.where(active, 0.0, resid) + added

    rounds, (rank, resid) = run_dense(step, (rank0, resid0),
                                      lambda s: torch.any(s[1] > tol), max_iters)
    rank = rank + resid
    rank = rank / rank.sum()
    return torch.where(valid, rank, 0.0), _dense_stats(g, rounds)


"""PageRank — topology-driven pull vs data-driven residual push, as in
``repro.core.algorithms.pagerank``, on resident and tiered graphs.

* ``pr_pull``  power-iteration pull (needs CSC); dangling mass is spread
               uniformly.
* ``pr_push``  residual push (PR-Delta): only vertices with residual > tol
               push.  Converges to the same fixpoint.
* ``ppr_push`` personalized PageRank by residual push from one source.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from .. import operators as ops
from ..engine import RunStats, run_dense, run_host, run_streamed
from ..graph import Graph, set_at


class PRState(NamedTuple):
    """Un-normalised (rank, residual) pair; the push invariant
    ``resid = (1-d)·1 − rank + d·P rank`` holds for it at every point."""

    rank: torch.Tensor
    resid: torch.Tensor


def _dense_stats(g, rounds, io0=None) -> RunStats:
    """Stats for ``rounds`` dense rounds; on a tiered graph the edge and
    h2d accounting is the stream counters' delta since ``io0``."""
    stats = RunStats.from_graph(g, rounds=rounds, dense_rounds=rounds)
    if io0 is not None:
        g.io.fold_delta(stats, io0)
    else:
        stats.edges_touched = rounds * g.m
    return stats


def _io_snapshot(g):
    return g.io.snapshot() if getattr(g, "is_tiered", False) else None


def pr_pull(g: Graph, damping: float = 0.85, tol: float = 1e-6,
            max_iters: int = 100):
    """Power-iteration pull PageRank.  On a tiered graph with a CSC mirror
    the rounds run eagerly (``run_host``): each one streams the whole
    in-edge cut through the buffer pool, and float sums associate per
    shard, so ranks are allclose (not bitwise) to the resident run."""
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

    io0 = _io_snapshot(g)
    runner = run_host if io0 is not None else run_dense
    rounds, (rank, _) = runner(step, (rank0, float("inf")),
                               lambda s: s[1] > tol, max_iters)
    return rank, _dense_stats(g, rounds, io0)


@lru_cache(maxsize=None)
def _pr_streamed_fns(damping: float, tol: float):
    """(step, cond, active) of the streamed pr_push, one triple per
    (damping, tol).  The step takes the container it is handed (the
    TieredGraph, or a StagedShards set inside a stretch), whose
    ``out_deg`` is the same device array."""
    def step(gr, state):
        rank, resid = state
        outdeg = torch.clamp(gr.out_deg.to(torch.float32), min=1.0)
        active = resid > tol
        rank = rank + torch.where(active, resid, 0.0)
        push_val = torch.where(active, damping * resid / outdeg, 0.0)
        added = ops.push_dense(gr, push_val, active, torch.zeros_like(resid),
                               kind="add", use_weight=False)
        return rank, torch.where(active, 0.0, resid) + added

    def cond(state):
        return torch.any(state[1] > tol)

    def active_fn(gr, state):
        return state[1] > tol

    return step, cond, active_fn


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
    the cold uniform start); returns the raw ``(rank, resid, rounds)``.  A
    tiered graph runs through ``run_streamed``, a resident one through
    ``run_dense``."""
    if state0 is None:
        rank0 = torch.zeros((g.n_pad,), dtype=torch.float32, device=g.device)
        resid0 = torch.where(g.valid_vertex_mask(), 1.0 - damping, 0.0)
    else:
        rank0, resid0 = state0
    if getattr(g, "is_tiered", False):
        step, cond, active = _pr_streamed_fns(float(damping), float(tol))
        rounds, (rank, resid) = run_streamed(
            g, step, (rank0, resid0), cond, active, max_iters)
    else:
        rounds, (rank, resid) = run_dense(
            _pr_step(g, damping, tol), (rank0, resid0),
            lambda s: torch.any(s[1] > tol), max_iters)
    return rank, resid, rounds


def pr_push(g: Graph, damping: float = 0.85, tol: float = 1e-9,
            max_iters: int = 10_000):
    """Residual push PageRank, normalised at the end to match ``pr_pull``.
    On a tiered graph stable residual-active shard sets run as staged
    stretches, and the edge and h2d accounting comes from the stream
    counters."""
    io0 = _io_snapshot(g)
    rank, resid, rounds = _pr_push_raw(g, damping, tol, max_iters)
    rank = rank + resid  # fold in the leftover residual
    rank = torch.where(g.valid_vertex_mask(), rank / rank.sum(), 0.0)
    return rank, _dense_stats(g, rounds, io0)


def ppr_push(g: Graph, src: int, damping: float = 0.85, tol: float = 1e-9,
             max_iters: int = 10_000):
    """Personalized PageRank by residual push from a single source."""
    valid = g.valid_vertex_mask()
    outdeg = torch.clamp(g.out_deg.to(torch.float32), min=1.0)
    rank0 = torch.zeros((g.n_pad,), dtype=torch.float32, device=g.device)
    resid0 = rank0.clone()
    set_at(resid0, src, 1.0)

    def step(state):
        rank, resid = state
        active = resid > tol
        set_at(active, -1, False)
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


"""PageRank — topology-driven pull vs data-driven residual push, as in
``repro.core.algorithms.pagerank``, on resident and tiered graphs.

* ``pr_pull``  power-iteration pull (needs CSC); dangling mass is spread
               uniformly.
* ``pr_push``  residual push (PR-Delta): only vertices with residual > tol
               push.  Converges to the same fixpoint.
* ``ppr_push`` personalized PageRank by residual push from one source.
* ``pr_incremental`` the residual push carried across the update batches of
               a ``dynamic.DynamicGraph``.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ...kernels import graph_ops as gk
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


def _gate(tol: float, absolute: bool):
    """The activity test of a residual: ``resid > tol``, or ``|resid| >
    tol`` for a warm start, whose signed residuals (an insert lowers
    1/out_deg, so the correction takes mass off existing edges) must drain
    both ways."""
    if absolute:
        return lambda resid: torch.abs(resid) > tol
    return lambda resid: resid > tol


@lru_cache(maxsize=None)
def _pr_streamed_fns(damping: float, tol: float, absolute: bool = False):
    """(step, cond, active) of the streamed pr_push, one triple per
    (damping, tol, absolute).  The step takes the container it is handed
    (the TieredGraph, or a StagedShards set inside a stretch), whose
    ``out_deg`` is the same device array."""
    gate = _gate(tol, absolute)

    def step(gr, state):
        rank, resid = state
        outdeg = torch.clamp(gr.out_deg.to(torch.float32), min=1.0)
        active = gate(resid)
        rank = rank + torch.where(active, resid, 0.0)
        push_val = torch.where(active, damping * resid / outdeg, 0.0)
        added = ops.push_dense(gr, push_val, active, torch.zeros_like(resid),
                               kind="add", use_weight=False)
        return rank, torch.where(active, 0.0, resid) + added

    def cond(state):
        return torch.any(gate(state[1]))

    def active_fn(gr, state):
        return gate(state[1])

    return step, cond, active_fn


def _pr_step(g, damping, tol, absolute=False):
    outdeg = torch.clamp(g.out_deg.to(torch.float32), min=1.0)
    gate = _gate(tol, absolute)

    def step(state):
        rank, resid = state
        active = gate(resid)
        rank = rank + torch.where(active, resid, 0.0)
        push_val = torch.where(active, damping * resid / outdeg, 0.0)
        added = ops.push_dense(g, push_val, active, torch.zeros_like(resid),
                               kind="add", use_weight=False)
        return rank, torch.where(active, 0.0, resid) + added

    return step


def _pr_push_raw(g, damping, tol, max_iters, checkpointer=None, state0=None,
                 absolute=False):
    """Run the residual-push iteration to convergence from ``state0`` (or
    the cold uniform start); returns the raw ``(rank, resid, rounds)``, no
    residual folded in and not normalised, so it can seed a warm solve.  A
    tiered graph runs through ``run_streamed`` (which takes the
    ``checkpointer``), a resident one through ``run_dense``."""
    if state0 is None:
        rank0 = torch.zeros((g.n_pad,), dtype=torch.float32, device=g.device)
        resid0 = torch.where(g.valid_vertex_mask(), 1.0 - damping, 0.0)
    else:
        rank0, resid0 = state0
    if getattr(g, "is_tiered", False):
        step, cond, active = _pr_streamed_fns(float(damping), float(tol),
                                              bool(absolute))
        rounds, (rank, resid) = run_streamed(
            g, step, (rank0, resid0), cond, active, max_iters,
            checkpointer=checkpointer)
    else:
        gate = _gate(tol, absolute)
        rounds, (rank, resid) = run_dense(
            _pr_step(g, damping, tol, absolute), (rank0, resid0),
            lambda s: torch.any(gate(s[1])), max_iters)
    return rank, resid, rounds


def _normalised(g, rank, resid):
    """The leftover residual folded in, normalised to sum to 1."""
    rank = rank + resid
    return torch.where(g.valid_vertex_mask(), rank / rank.sum(), 0.0)


def pr_push(g: Graph, damping: float = 0.85, tol: float = 1e-9,
            max_iters: int = 10_000, checkpointer=None):
    """Residual push PageRank, normalised at the end to match ``pr_pull``.
    On a tiered graph stable residual-active shard sets run as staged
    stretches, the edge and h2d accounting comes from the stream counters,
    and ``checkpointer`` snapshots (rank, residual) and resumes an
    interrupted run (bitwise under ``operators.set_deterministic_add``)."""
    io0 = _io_snapshot(g)
    rank, resid, rounds = _pr_push_raw(g, damping, tol, max_iters,
                                       checkpointer=checkpointer)
    return _normalised(g, rank, resid), _dense_stats(g, rounds, io0)


def _delta_correction(g, delta, rank, resid, damping):
    """Fold an accepted edge batch into the push invariant.  With od =
    max(out_deg, 1), every pre-existing out-edge of a dirty source rescales
    from 1/od_old to 1/od_new and the batch's edges appear, so

        resid' = resid + d·[push_{G'}(rank·(1/od_new − 1/od_old), dirty)
                            + Σ_{(u,v)∈batch} rank[u]/od_old[u] at v]

    The first term relaxes through the container (the batch already sits
    in its logs); the second is the fixed-order ``det_scatter_add`` over
    the batch, so the correction is deterministic whenever the
    container's adds are."""
    dev = rank.device
    od_new = torch.clamp(g.out_deg.to(torch.float32), min=1.0)
    od_old = torch.clamp(torch.from_numpy(np.asarray(delta.old_out_deg))
                         .to(dev).to(torch.float32), min=1.0)
    dirty = torch.zeros((g.n_pad,), dtype=torch.bool, device=dev)
    dirty[torch.from_numpy(delta.dirty.astype(np.int64)).to(dev)] = True
    val = torch.where(dirty, rank * (1.0 / od_new - 1.0 / od_old), 0.0)
    scaled = ops.push_dense(g, val, dirty, torch.zeros_like(rank), kind="add",
                            use_weight=False)
    src = torch.from_numpy(delta.src.astype(np.int64)).to(dev)
    dst = torch.from_numpy(delta.dst.astype(np.int64)).to(dev)
    fresh = gk.det_scatter_add(dst, rank[src] / od_old[src], torch.zeros_like(rank))
    return resid + damping * (scaled + fresh)


def pr_incremental(g, delta=None, state: PRState | None = None,
                   damping: float = 0.85, tol: float = 1e-9,
                   max_iters: int = 10_000, checkpointer=None):
    """Incremental residual-push PageRank over a ``dynamic.DynamicGraph``.

    Cold call (``state=None``): a from-scratch ``pr_push`` solve that also
    returns its raw ``PRState``.  Warm call: the accepted ``DeltaBatch``
    becomes a residual correction (``_delta_correction``) and the push
    re-converges from the vertices whose residual it disturbed.  Returns
    ``(rank normalised like pr_push's, RunStats, raw PRState)``.

    Allclose to a from-scratch ``pr_push`` on the updated container, and
    bitwise reproducible (same container, same batch history, any pool
    size, substrate or regime) under ``operators.set_deterministic_add``."""
    io0 = _io_snapshot(g)
    if state is None:
        rank, resid, rounds = _pr_push_raw(g, damping, tol, max_iters,
                                           checkpointer=checkpointer)
    else:
        rank0, resid0 = state.rank, state.resid
        if delta is not None and delta.inserted:
            resid0 = _delta_correction(g, delta, rank0, resid0, damping)
        rank, resid, rounds = _pr_push_raw(
            g, damping, tol, max_iters, checkpointer=checkpointer,
            state0=(rank0, resid0), absolute=True)
    return (_normalised(g, rank, resid), _dense_stats(g, rounds, io0),
            PRState(rank=rank, resid=resid))


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


VARIANTS = {"pull": pr_pull, "push": pr_push}

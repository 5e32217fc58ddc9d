"""Dynamic graph deltas — an interleaved insert/query stream against full
recomputation, the port's counterpart of the JAX package's
``benchmarks/dynamic.py``: the same rows, flags and graph.

The base graph is persisted (``checkpoint.save_graph``), reopened as a
``DynamicGraph`` (``open_dynamic``) and driven through insert batches
(``apply_batch(..., symmetrize=True)``) and queries:

* ``stream_incremental`` — after each batch ``bfs_incremental`` and
  ``cc_incremental`` re-converge from the batch's dirty vertices; every
  answer must equal the from-scratch run on the same container bitwise
  (``equal``), and ``frac`` is the share of the recompute's edges the
  stream touched;
* ``stream_recompute`` — the same queries answered from scratch after each
  batch: what an immutable CSR pays;
* ``pr_incremental`` — the residual-carrying pagerank over the same
  accepted batches under deterministic add, replayed on fresh handles at
  two pool sizes: allclose to a from-scratch ``pr_push`` (``allclose``:
  rtol 1e-3 and the JAX suite's atol 1e-6 at its n = 1,024, about a
  thousandth of the mean normalised rank, held at that share of the mean
  rank 1/n at any n) and bitwise equal across the pools (``det``);
* ``compact`` — ``save_dynamic`` / ``open_dynamic`` round trip
  (``roundtrip``), then ``compact()``: queries equal before and after,
  and one more batch still answers incrementally (``equal``).  Its time
  is that compaction's wall (the JAX suite times compactions of fresh
  handles).

    python -m repro_torch.benchmarks.dynamic [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

import shutil
import tempfile
import time

import torch

from ..checkpoint import open_dynamic, save_dynamic, save_graph
from ..core import operators as ops
from ..core.algorithms import bfs, cc, pagerank
from ..core.graph import _device, from_coo
from .common import _sync, row, suite_main

HOLD = 448       # the JAX suite's held-out tail: 6 batches of 64, then 64
NSHARDS = 16     # the store's cut
PR_ITERS = 300   # each pagerank solve's cap
PR_RTOL = 1e-3


def pr_atol(n: int) -> float:
    """``allclose``'s atol on normalised ranks: the JAX suite's 1e-6 at its
    n = 1,024, scaled with the mean rank 1/n."""
    return 1e-6 * 1024 / n


def default_inputs(device=None):
    """The JAX suite's stream: ``rmat(10, 12, seed=11)`` with its last 448
    edges held out; the base built symmetrized at block 128, 6 batches of
    64 and 64 more after compaction."""
    from ..graphs import generators as gen

    src, dst, n = gen.rmat(10, 12, seed=11)
    hs, hd = src[-HOLD:], dst[-HOLD:]
    g0 = from_coo(src[:-HOLD], dst[:-HOLD], n, block_size=128, symmetrize=True,
                  device=device)
    batches = [(hs[k:k + 64], hd[k:k + 64]) for k in range(0, 6 * 64, 64)]
    return g0, batches, (hs[6 * 64:], hd[6 * 64:])


def run(base=None, batches=None, post=None, pools=(4, 8), source: int = 0,
        pr_batches=None, det_iters=PR_ITERS, store=None, device=None, log=None):
    """The four rows.  ``base`` is a symmetrized ``Graph``, ``batches`` a
    list of host ``(src, dst)`` pairs, ``post`` the batch after
    compaction (the JAX suite's inputs by default).  ``pools[0]`` is the
    stream's pool and both pools replay pagerank; ``store`` is the
    directory of the store (a temporary one by default, removed at the
    end); ``log`` (a callable) receives one line per batch and per replay.

    Two depth cuts, both off by default: the pagerank replays take only
    the first ``pr_batches`` batches, and with ``det_iters`` below
    PR_ITERS the cross-pool ``det`` pair is a third and fourth replay
    whose every solve stops after ``det_iters`` rounds, at both pools,
    while ``allclose`` holds the converged replay at ``pools[0]``."""
    dev = _device(device)
    if base is None:
        base, batches, post = default_inputs(dev)
    own = store is None
    store = tempfile.mkdtemp(prefix="dyn_store_") if own else str(store)
    rows = []
    try:
        # the logs have no CSC mirror: a dynamic graph never pulls
        save_graph(base, store, nshards=NSHARDS, build_csc=False)
        dyn = open_dynamic(store, resident_shards=pools[0], device=dev)
        budget_ratio = dyn.csr_bytes / max(dyn.resident_budget, 1)
        dist, _ = bfs.bfs_dd_sparse(dyn, source)
        lab, _ = cc.cc_dd_sparse(dyn)

        inc_edges = rec_edges = inserted = 0
        inc_us = rec_us = 0.0
        bitwise = True
        for i, (s, d) in enumerate(batches):
            delta = dyn.apply_batch(s, d, symmetrize=True)
            inserted += delta.inserted
            t = time.perf_counter()
            dist, st_b = bfs.bfs_incremental(dyn, dist, delta)
            lab, st_c = cc.cc_incremental(dyn, lab, delta)
            _sync()
            t_inc = (time.perf_counter() - t) * 1e6
            inc_edges += st_b.edges_touched + st_c.edges_touched
            t = time.perf_counter()
            d_scr, sb = bfs.bfs_dd_sparse(dyn, source)
            l_scr, sc = cc.cc_dd_sparse(dyn)
            _sync()
            t_rec = (time.perf_counter() - t) * 1e6
            rec_edges += sb.edges_touched + sc.edges_touched
            same = torch.equal(dist, d_scr) and torch.equal(lab, l_scr)
            bitwise &= same
            inc_us += t_inc
            rec_us += t_rec
            if log is not None:
                log(f"batch {i}: inserted {delta.inserted} (dirty {delta.dirty.size}); "
                    f"incremental bfs+cc {t_inc / 1e3} ms, edges {st_b.edges_touched} + "
                    f"{st_c.edges_touched}; from scratch {t_rec / 1e3} ms, edges "
                    f"{sb.edges_touched} + {sc.edges_touched}; bitwise {same}")

        work_frac = inc_edges / max(rec_edges, 1)
        rows.append(row(
            "dynamic/stream_incremental", inc_us / len(batches),
            f"edges={inc_edges};frac={work_frac:.2f};equal={int(bitwise)}",
            {"edges_touched": inc_edges, "bitwise_equal": int(bitwise),
             "work_frac": work_frac, "batches": len(batches), "inserts": inserted}))
        rows.append(row(
            "dynamic/stream_recompute", rec_us / len(batches), f"edges={rec_edges}",
            {"edges_touched": rec_edges, "batches": len(batches)}))

        # pagerank: the same batches through the residual-carrying solver on
        # fresh handles at two pool sizes: allclose to scratch, bitwise
        # equal to each other
        def pr_replay(pool, iters):
            h = open_dynamic(store, resident_shards=pool, device=dev)
            t = time.perf_counter()
            with ops.deterministic_add_scope(True):
                _, st, state = pagerank.pr_incremental(h, tol=1e-6, max_iters=iters)
                rounds = [st.rounds]
                for s, d in batches[:pr_batches]:
                    db = h.apply_batch(s, d, symmetrize=True)
                    _, st, state = pagerank.pr_incremental(
                        h, db, state, tol=1e-6, max_iters=iters)
                    rounds.append(st.rounds)
                rank, st, _ = pagerank.pr_incremental(h, state=state, tol=1e-6,
                                                      max_iters=iters)
            _sync()
            if log is not None:
                log(f"pagerank replay at a pool of {pool}, at most {iters} rounds a solve: "
                    f"rounds per solve {rounds + [st.rounds]}, {time.perf_counter() - t} s")
            return h, rank, state.rank, st

        t = time.perf_counter()
        h0, rank0, raw0, st_pr = pr_replay(pools[0], PR_ITERS)
        _sync()
        pr_us = (time.perf_counter() - t) * 1e6
        with ops.deterministic_add_scope(True):
            scratch, _ = pagerank.pr_push(h0, tol=1e-6, max_iters=PR_ITERS)
        # torch.allclose's test, with its margin kept for the log
        atol = pr_atol(h0.n)
        margin = float(((rank0 - scratch).abs() / (atol + PR_RTOL * scratch.abs())).max())
        allclose = margin <= 1.0
        if log is not None:
            log(f"pagerank against scratch: largest |diff| / (atol + rtol |scratch|) "
                f"{margin} (atol {atol}, rtol {PR_RTOL})")
        del h0
        if det_iters < PR_ITERS:
            _, rank0, raw0, _ = pr_replay(pools[0], det_iters)
        _, rank1, raw1, _ = pr_replay(pools[1], det_iters)
        det_bitwise = torch.equal(rank0, rank1) and torch.equal(raw0, raw1)
        rows.append(row(
            "dynamic/pr_incremental", pr_us,
            f"allclose={int(allclose)};det={int(det_bitwise)}",
            {"allclose": int(allclose), "det_bitwise": int(det_bitwise),
             "edges_touched": st_pr.edges_touched}))

        # compaction: the store round trip, answers pinned across the
        # compaction, and the next batch still incremental
        save_dynamic(dyn, store)
        rt = open_dynamic(store, resident_shards=pools[0], device=dev)
        roundtrip_equal = torch.equal(dist, bfs.bfs_dd_sparse(rt, source)[0])
        del rt
        _sync()
        t = time.perf_counter()
        dyn.compact()
        _sync()
        us = (time.perf_counter() - t) * 1e6
        d_post, _ = bfs.bfs_dd_sparse(dyn, source)
        l_post, _ = cc.cc_dd_sparse(dyn)
        bitwise_after = torch.equal(dist, d_post) and torch.equal(lab, l_post)
        delta = dyn.apply_batch(*post, symmetrize=True)
        d_inc, _ = bfs.bfs_incremental(dyn, d_post, delta)
        bitwise_after &= torch.equal(d_inc, bfs.bfs_dd_sparse(dyn, source)[0])
        rows.append(row(
            "dynamic/compact", us,
            f"equal={int(bitwise_after)};roundtrip={int(roundtrip_equal)};"
            f"ratio={budget_ratio:.0f}x",
            {"bitwise_after_compact": int(bitwise_after),
             "roundtrip_equal": int(roundtrip_equal),
             "budget_ratio": budget_ratio, "m": dyn.m}))
    finally:
        if own:
            shutil.rmtree(store, ignore_errors=True)
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("dynamic", run, __doc__))

"""Paper Fig. 11 — one big-memory machine against a distributed cluster:
the port's counterpart of the JAX package's ``benchmarks/vs_cluster.py``.

On web_crawl_like(24, 5, 10, 2) symmetrized:

* ``OB`` — the single-partition engine's best algorithms (sparse bfs,
  pointer-jump cc);
* ``OA`` — single partition, vertex programs only (dense bfs, label-prop
  cc);
* ``DM`` — the CVC-partitioned BSP vertex programs on a (4, 2) mesh of 8
  positions (the D-Galois class).

Rows report rounds and the sync bytes a round's dense label exchange
costs the cluster (rounds × 4 n_pad bytes × 8), zero for one partition.

    python -m repro_torch.benchmarks.vs_cluster [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from ..core import partition as pt
from ..core.algorithms import bfs, cc
from ..core.mesh import Mesh
from .common import row, suite_main, timed


def bench_graph(device=None):
    """The JAX suite's graph: web_crawl_like(24, 5, 10, 2, seed=2),
    symmetrized at block size 512, and its largest out-degree vertex."""
    from ..core.graph import from_coo
    from ..graphs import generators as gen

    src, dst, n = gen.web_crawl_like(24, 5, 10, 2, seed=2)
    g = from_coo(src, dst, n, block_size=512, symmetrize=True, device=device)
    s = g.src_idx[: g.m].cpu().numpy()
    return g, int(np.argmax(np.bincount(s, minlength=n)))


def run(graph=None, warmup: int = 1, iters: int = 3, device=None, results=None):
    """The Fig. 11 rows on ``graph = (g, source)`` (by default
    ``bench_graph()``); ``results`` receives each row's labels."""
    g, source = bench_graph(device) if graph is None else graph
    label_bytes = 4 * g.n_pad   # one dense label sync a round per position
    rows = []

    def add(name, fn, bsp=False):
        # an engine run returns (labels, RunStats), a BSP run (labels, rounds)
        (out, extra), us = timed(fn, warmup, iters)
        rounds = extra if bsp else extra.rounds
        sync = rounds * label_bytes * 8 if bsp else 0
        rows.append(row(name, us, f"rounds={rounds};sync_bytes={sync}"))
        if results is not None:
            results[name] = out

    add("fig11/bfs/OB", lambda: bfs.bfs_dd_sparse(g, source))
    add("fig11/cc/OB", lambda: cc.cc_pointer_jump(g))
    add("fig11/bfs/OA", lambda: bfs.bfs_dd_dense(g, source))
    add("fig11/cc/OA", lambda: cc.cc_labelprop(g))
    mesh = Mesh({"data": 4, "model": 2}, device=g.device)
    pg = pt.partition_2d(g, 4, 2)
    add("fig11/bfs/DM", lambda: pt.bsp_bfs(pg, mesh, ("data", "model"), source), bsp=True)
    add("fig11/cc/DM", lambda: pt.bsp_cc(pg, mesh, ("data", "model")), bsp=True)
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("vs_cluster", run, __doc__))

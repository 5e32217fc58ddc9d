"""Paper Fig. 4/5 — block granularity, the port's counterpart of the JAX
package's ``benchmarks/granularity.py``: the same rows on the same graph.

``block_size`` sets the worklist ladder's rungs and the per-round
dispatch overhead (the analogue of the paper's page size and its
translation metadata).  The sparse-worklist BFS runs from the web graph's
hub at block sizes 64, 512 and 4096; each row reports its wall time, the
distinct rung loops it asked for (``compiles``, the reference's trace
count), its rounds, sparse rounds and edges touched.

    python -m repro_torch.benchmarks.granularity [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from ..core.algorithms import bfs
from ..core.graph import _device, from_coo
from .common import bench_graphs, row, suite_main, timed

BLOCK_SIZES = (64, 512, 4096)


def run(graphs=None, warmup: int = 1, iters: int = 3, device=None, results=None):
    """The rows ``fig5/bfs_block{bs}``.  ``graphs`` is the host COO
    ``(src, dst, n)`` the graph is built from at each block size
    (``bench_graphs()["web"]`` by default); ``results``, a dict, receives
    each row's distances under its name."""
    dev = _device(device)
    src, dst, n = bench_graphs()["web"] if graphs is None else graphs
    source = int(np.argmax(np.bincount(src, minlength=n)))
    rows = []
    for bs in BLOCK_SIZES:
        g = from_coo(src, dst, n, block_size=bs, device=dev)
        (dist, stats), us = timed(lambda: bfs.bfs_dd_sparse(g, source), warmup, iters)
        name = f"fig5/bfs_block{bs}"
        rows.append(row(
            name, us,
            f"compiles={stats.compiles};rounds={stats.rounds};"
            f"sparse_rounds={stats.sparse_rounds};edges={stats.edges_touched}",
            stats.as_dict()))
        if results is not None:
            results[name] = dist
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("granularity", run, __doc__))

"""Paper Fig. 8/9 — framework capability classes on one engine, the
port's counterpart of the JAX package's ``benchmarks/frameworks.py``.

The engine is restricted to each framework's documented capability class
(the paper's explanation of the gaps between them):

  graphit-class : dense worklists, vertex programs only, direction-opt BFS,
                  label-prop CC, no delta-stepping.
  gap-class     : + delta-stepping SSSP, still dense worklists.
  gbbs-class    : dense bitmap frontiers, theory-efficient variants.
  galois-class  : sparse worklists, delta-stepping, non-vertex
                  pointer-jumping CC, push-residual PR.

Rows ``fig8/{bfs,sssp,cc,pr}/{class}`` and the class-independent
``fig8/{bc,kcore,tc}/all``, each with its ``RunStats`` (tc's with its
count).

    python -m repro_torch.benchmarks.frameworks [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

from ..core.algorithms import bc, bfs, cc, kcore, pagerank, sssp, tc
from .common import row, suite_main, timed

CLASSES = {
    "graphit": dict(bfs=bfs.bfs_dirop, sssp=sssp.sssp_dd_dense,
                    cc=cc.cc_labelprop, pr=pagerank.pr_pull),
    "gap": dict(bfs=bfs.bfs_dirop, sssp=sssp.sssp_delta,
                cc=cc.cc_pointer_jump, pr=pagerank.pr_pull),
    "gbbs": dict(bfs=bfs.bfs_dd_dense, sssp=sssp.sssp_delta,
                 cc=cc.cc_labelprop_sc, pr=pagerank.pr_pull),
    "galois": dict(bfs=bfs.bfs_dd_sparse, sssp=sssp.sssp_delta,
                   cc=cc.cc_pointer_jump, pr=pagerank.pr_push),
}


def containers(src, dst, n, device=None, seed: int = 3):
    """``(g, gsym, source)`` as the JAX suites build them from host COO:
    the weighted CSR+CSC graph, the symmetrized CSR+CSC graph and the
    largest out-degree vertex, at block size 512."""
    import numpy as np

    from ..core.graph import from_coo
    from ..graphs import generators as gen

    w = gen.random_weights(len(src), seed=seed)
    g = from_coo(src, dst, n, w, block_size=512, build_csc=True, device=device)
    gsym = from_coo(src, dst, n, block_size=512, symmetrize=True,
                    build_csc=True, device=device)
    return g, gsym, int(np.argmax(np.bincount(src, minlength=n)))


def run(graphs=None, warmup: int = 1, iters: int = 3, device=None, results=None):
    """The Fig. 8 rows on ``graphs = (g, gsym, source)`` (by default the
    ``bench_graphs()["web"]`` containers); ``results``, a dict, receives
    each row's labels (tc: its count) under its name."""
    if graphs is None:
        from .common import bench_graphs
        graphs = containers(*bench_graphs()["web"], device=device)
    g, gsym, source = graphs
    rows = []

    def add(name, fn, count=False):
        (out, stats), us = timed(fn, warmup, iters)
        extra = dict(count=int(out)) if count else {}
        derived = f"rounds={stats.rounds};edges={stats.edges_touched}"
        rows.append(row(name, us, (f"count={int(out)};" if count else "") + derived,
                        dict(stats.as_dict(), **extra)))
        if results is not None:
            results[name] = out

    for cname, algs in CLASSES.items():
        add(f"fig8/bfs/{cname}", lambda: algs["bfs"](g, source))
        add(f"fig8/sssp/{cname}", lambda: algs["sssp"](g, source))
        add(f"fig8/cc/{cname}", lambda: algs["cc"](gsym))
        add(f"fig8/pr/{cname}", lambda: algs["pr"](gsym))
    # class-independent benchmarks (the same code in every class)
    add("fig8/bc/all", lambda: bc.bc_brandes(g, source))
    add("fig8/kcore/all", lambda: kcore.kcore_peel(gsym, 3))
    add("fig8/tc/all", lambda: tc.tc_count(gsym, edge_chunk=8192), count=True)
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("frameworks", run, __doc__))

"""Paper Fig. 6/7 — algorithm classes × graph diameter, the port's
counterpart of the JAX package's ``benchmarks/algo_classes.py``.

The paper's claim (P3): on high-diameter web crawls, data-driven
sparse-worklist and non-vertex algorithms beat bulk-synchronous dense
vertex programs; on low-diameter rmat/kron the ranking flips.  Every
variant × graph row reports its wall time and ``RunStats`` (the work
counter ``edges_touched`` is machine-independent): the bfs, sssp and cc
variant matrices, bc, the dense against the sparse-ladder kcore peel,
both pageranks and tc.

The JAX suite's sharded tc cell (``fig7/tc/rmat/dev1`` and ``dev4``, a
4-device mesh) belongs to the multi-device path, which the port does not
have yet (ROADMAP queue 1, item 11); the suite prints one line saying so.

    python -m repro_torch.benchmarks.algo_classes [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

from ..core.algorithms import bc, bfs, cc, kcore, pagerank, sssp, tc
from .common import row, suite_main, timed
from .frameworks import containers

SHARDED_TC_NOTE = ("fig7/tc/rmat/dev1, fig7/tc/rmat/dev4: the sharded tc cell "
                   "is left out until the multi-device path (ROADMAP queue 1, "
                   "item 11)")


def run(graphs=None, warmup: int = 1, iters: int = 3, device=None, results=None):
    """Every variant × graph row on ``graphs = {name: (g, gsym, source)}``
    (by default the ``bench_graphs()`` containers, built as the JAX suite
    builds them); ``results``, a dict, receives each row's labels (tc: its
    count) under its name."""
    if graphs is None:
        from .common import bench_graphs
        graphs = {name: containers(*coo, device=device)
                  for name, coo in bench_graphs().items()}
    rows = []

    def add(name, fn, derived, count=False):
        (out, stats), us = timed(fn, warmup, iters)
        extra = dict(count=int(out)) if count else {}
        rows.append(row(name, us, derived(out, stats), dict(stats.as_dict(), **extra)))
        if results is not None:
            results[name] = out

    def plain(out, stats):
        return f"rounds={stats.rounds};edges={stats.edges_touched}"

    for gname, (g, gsym, source) in graphs.items():
        for vname, fn in bfs.VARIANTS.items():
            add(f"fig6/bfs/{gname}/{vname}", lambda: fn(g, source), plain)
        for vname, fn in sssp.VARIANTS.items():
            add(f"fig6/sssp/{gname}/{vname}", lambda: fn(g, source), plain)
        for vname, fn in cc.VARIANTS.items():
            add(f"fig6/cc/{gname}/{vname}", lambda: fn(gsym), plain)
        # bc: both sweeps (2 forward + 1 backward relax a level) through the seam
        add(f"fig7/bc/{gname}/brandes", lambda: bc.bc_brandes(g, source), plain)
        # kcore: the dense peel against the sparse-ladder peel
        for vname, fn in kcore.VARIANTS.items():
            add(f"fig7/kcore/{gname}/{vname}", lambda: fn(gsym, 4),
                lambda out, st: plain(out, st) + f";sparse_rounds={st.sparse_rounds}")
        for vname, fn in pagerank.VARIANTS.items():
            add(f"fig7/pagerank/{gname}/{vname}", lambda: fn(gsym), plain)
        add(f"fig7/tc/{gname}/orient_intersect",
            lambda: tc.tc_count(gsym, edge_chunk=8192),
            lambda out, st: f"count={out};edges={st.edges_touched}", count=True)
    print(SHARDED_TC_NOTE, flush=True)
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("algo_classes", run, __doc__))

"""Paper Fig. 6/7 — algorithm classes × graph diameter, the port's
counterpart of the JAX package's ``benchmarks/algo_classes.py``.

The paper's claim (P3): on high-diameter web crawls, data-driven
sparse-worklist and non-vertex algorithms beat bulk-synchronous dense
vertex programs; on low-diameter rmat/kron the ranking flips.  Every
variant × graph row reports its wall time and ``RunStats`` (the work
counter ``edges_touched`` is machine-independent): the bfs, sssp and cc
variant matrices, bc, the dense against the sparse-ladder kcore peel,
both pageranks and tc.

The sharded tc cell closes the suite, as in the JAX one:
``fig7/tc/rmat/dev1`` counts rmat(9, 10)'s triangles on one partition and
``fig7/tc/rmat/dev4`` on a 4-position mesh (``shard_graph``, tc sharded
by edge chunk), which must give the same count.

    python -m repro_torch.benchmarks.algo_classes [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

from ..core.algorithms import bc, bfs, cc, kcore, pagerank, sssp, tc
from ..core.mesh import Mesh
from ..core.sharded import shard_graph
from .common import row, suite_main, timed, timed_samples, wall_fields
from .frameworks import containers

SHARDED_TC_POSITIONS = 4


def sharded_tc_rows(device=None, warmup: int = 1, iters: int = 3, results=None):
    """The sharded tc cell: rmat(9, 10, seed=1) symmetrized at block size
    256, counted on one partition and on a mesh of
    ``SHARDED_TC_POSITIONS`` (edge chunk 4,096); the counts must agree."""
    import numpy as np

    from ..core.graph import from_coo
    from ..graphs import generators as gen

    src, dst, n = gen.rmat(9, 10, seed=1)
    g = from_coo(src, dst, n, block_size=256, symmetrize=True, device=device)
    sg = shard_graph(g, Mesh({"data": SHARDED_TC_POSITIONS}, device=g.device), ("data",),
                     policy="blocked")
    rows = []
    for name, graph, extra in (("fig7/tc/rmat/dev1", g, False),
                               (f"fig7/tc/rmat/dev{SHARDED_TC_POSITIONS}", sg, True)):
        (count, st), samples = timed_samples(lambda: tc.tc_count(graph, edge_chunk=4096),
                                             warmup, iters)
        us = float(np.median(samples))
        derived = f"count={count};edges={st.edges_touched}"
        if extra:
            derived += f";comm_elems={st.comm_elems}"
            if count != int(rows[0][3]["count"]):
                raise AssertionError(f"sharded tc counted {count}, one partition "
                                     f"{rows[0][3]['count']}")
        rows.append(row(name, us, derived, dict(st.as_dict(), count=int(count), wall_us=us,
                                                **wall_fields(samples))))
        if results is not None:
            results[name] = count
    return rows


def run(graphs=None, warmup: int = 1, iters: int = 3, device=None, results=None):
    """Every variant × graph row on ``graphs = {name: (g, gsym, source)}``
    (by default the ``bench_graphs()`` containers, built as the JAX suite
    builds them, and then the sharded tc cell at the JAX suite's own size);
    ``results``, a dict, receives each row's labels (tc: its count) under
    its name."""
    sharded_tc = graphs is None
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
    if sharded_tc:
        rows += sharded_tc_rows(device, warmup, iters, results)
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("algo_classes", run, __doc__))

"""Paper Fig. 10 — strong scaling over the mesh, engine against BSP, and
the CVC-against-full-mesh communication trajectory: the port's counterpart
of the JAX package's ``benchmarks/scaling.py``.

bfs on rmat(10, 12) over 1, 2, 4 and 8 mesh positions, per count:

* ``fig10/engine_bfs_dev{D}`` — the sharded ``SparseLadderEngine``
  (``shard_graph``, blocked placement, the communication-avoiding
  reducer): sparse worklists with per-shard budgets and escalation;
  ``fig10/engine_perround_bfs_dev1`` the same with one fetch a round.
* ``fig10/bsp_bfs_dev{D}`` — the ``partition.py`` BSP baseline: every
  round relaxes every shard.
* ``fig10/cvc2d_{cvc,full}_bfs_dev{D}`` (D >= 4) — the engine on a
  (2, D/2) ``partition_2d`` grid under both reducers.

The port's mesh is D positions on one device, so walls do not scale with
D: the counters carry the argument (``edges_touched``, the per-position
bytes ``bytes_per_dev``, the modelled ``comm_elems``).  Rows carry the
JAX rows' ``RunStats`` fields and wall fields, so ``python -m
benchmarks.ci_gate gate PATH`` reads the ``--emit-json`` output.

    python -m repro_torch.benchmarks.scaling [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

import numpy as np

from ..core.algorithms import bfs
from ..core.mesh import Mesh
from ..core import partition as pt
from ..core.sharded import shard_graph
from .common import row, suite_main, timed_samples, wall_fields

NDEVS = (1, 2, 4, 8)


def bench_graph(device=None):
    """The JAX suite's graph: rmat(10, 12, seed=1) at block size 512, and
    the source of most out-edges."""
    from ..core.graph import from_coo
    from ..graphs import generators as gen

    src, dst, n = gen.rmat(10, 12, seed=1)
    g = from_coo(src, dst, n, block_size=512, device=device)
    return g, int(np.argmax(np.bincount(src, minlength=n)))


def run(graph=None, warmup: int = 1, iters: int = 3, device=None, results=None,
        ndevs=NDEVS):
    """The Fig. 10 rows on ``graph = (g, source)`` (by default
    ``bench_graph()``); ``results``, a dict, receives each row's labels."""
    g, source = bench_graph(device) if graph is None else graph
    total_bytes = sum(a.numel() * a.element_size() for a in (g.col_idx, g.src_idx, g.edge_w))
    rows = []

    def add(name, fn, derived, stats):
        (out, st), samples = timed_samples(fn, warmup, iters)
        us = float(np.median(samples))
        rows.append(row(name, us, derived(out, st),
                        dict(stats(out, st), wall_us=us, **wall_fields(samples))))
        if results is not None:
            results[name] = out

    for d in ndevs:
        sg = shard_graph(g, Mesh({"data": d}, device=g.device), ("data",), policy="blocked")
        add(f"fig10/engine_bfs_dev{d}", lambda: bfs.bfs_dd_sparse(sg, source),
            lambda out, st: (f"edges_touched={st.edges_touched};"
                             f"sparse_rounds={st.sparse_rounds};"
                             f"dense_rounds={st.dense_rounds};"
                             f"comm_elems={st.comm_elems};"
                             f"bytes_per_dev={total_bytes // d}"),
            lambda out, st: dict(st.as_dict(), algo="bfs_dd_sparse", scheme="oec",
                                 reducer="cvc", bytes_per_dev=total_bytes // d))
        if d == 1:
            add(f"fig10/engine_perround_bfs_dev{d}",
                lambda: bfs.bfs_dd_sparse(sg, source, fused=False),
                lambda out, st: f"edges_touched={st.edges_touched};rounds={st.rounds}",
                lambda out, st: dict(st.as_dict(), algo="bfs_dd_sparse", scheme="oec",
                                     reducer="cvc", fused=False))
        mesh = Mesh({"data": d}, device=g.device)
        pg = pt.partition_1d(g, d)
        add(f"fig10/bsp_bfs_dev{d}", lambda: pt.bsp_bfs(pg, mesh, ("data",), source),
            lambda out, rounds: (f"edges_touched={rounds * g.m};rounds={rounds};"
                                 f"bytes_per_dev={total_bytes // d}"),
            lambda out, rounds: dict(algo="bsp_bfs", ndev=d, rounds=int(rounds),
                                     edges_touched=int(rounds) * g.m,
                                     bytes_per_dev=total_bytes // d))
        if d >= 4:
            grid = (2, d // 2)
            mesh2 = Mesh({"data": grid[0], "model": grid[1]}, device=g.device)
            for reducer in ("cvc", "full"):
                sg2 = shard_graph(g, mesh2, ("data", "model"), scheme="cvc", grid=grid,
                                  reducer=reducer)
                add(f"fig10/cvc2d_{reducer}_bfs_dev{d}",
                    lambda: bfs.bfs_dd_sparse(sg2, source),
                    lambda out, st: (f"comm_elems={st.comm_elems};"
                                     f"comm_bytes={st.comm_bytes};"
                                     f"reduce_axis_hops={st.reduce_axis_hops};"
                                     f"edges_touched={st.edges_touched}"),
                    lambda out, st: dict(st.as_dict(), algo="bfs_dd_sparse", scheme="cvc",
                                         grid=list(grid), reducer=reducer))
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("scaling", run, __doc__))

"""Communication-volume sweep — the CVC and owner-targeted reducers
against the full-mesh one: the port's counterpart of the JAX package's
``benchmarks/comm_volume.py``.

bfs on rmat(10, 12) over 1, 2, 4 and 8 mesh positions, under both
``shard_graph`` reducers, on two cuts:

* ``comm/oec_{cvc,full}_dev{D}`` — ``partition_1d`` shards: the owner1d
  reduce (a transpose of the (D, D, L) owner-laid contributions, then a
  gather) against the full-mesh reduce;
* ``comm/cvc2d_{cvc,full}_dev{D}`` (D >= 4) — ``partition_2d`` (2, D/2)
  grids: the column reduce and row gather against the full-mesh reduce.

Labels are held bitwise between the two reducers before a row is made, so
every row pair compares one computation.  Rows report the modelled volume
(``comm_elems``, ``comm_bytes``, ``reduce_axis_hops``; see
``sharded.CrossReducer.comm_per_relax``), the full/cvc ratio and the wall.

    python -m repro_torch.benchmarks.comm_volume [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

import torch

from ..core.algorithms import bfs
from ..core.mesh import Mesh
from ..core.sharded import shard_graph
from .common import row, suite_main, timed
from .scaling import NDEVS, bench_graph


def _cells(g, d):
    yield "oec", Mesh({"data": d}, device=g.device), ("data",), {}
    if d >= 4:
        grid = (2, d // 2)
        yield ("cvc2d", Mesh({"data": grid[0], "model": grid[1]}, device=g.device),
               ("data", "model"), dict(scheme="cvc", grid=grid))


def run(graph=None, warmup: int = 1, iters: int = 3, device=None, results=None,
        ndevs=NDEVS):
    """The comm rows on ``graph = (g, source)`` (by default
    ``scaling.bench_graph()``); ``results`` receives each row's labels."""
    g, source = bench_graph(device) if graph is None else graph
    rows = []
    for d in ndevs:
        for scheme, mesh, axes, kw in _cells(g, d):
            out = {}
            for reducer in ("cvc", "full"):
                sg = shard_graph(g, mesh, axes, policy="blocked", reducer=reducer, **kw)
                (labels, st), us = timed(lambda: bfs.bfs_dd_sparse(sg, source), warmup, iters)
                out[reducer] = (labels, st, us)
            if not torch.equal(out["cvc"][0], out["full"][0]):
                raise AssertionError(f"the reducers' labels differ: {scheme} dev{d}")
            cvc = out["cvc"][1].comm_elems
            ratio = out["full"][1].comm_elems / cvc if cvc else 1.0
            for reducer in ("cvc", "full"):
                labels, st, us = out[reducer]
                name = f"comm/{scheme}_{reducer}_dev{d}"
                rows.append(row(name, us,
                                f"comm_elems={st.comm_elems};comm_bytes={st.comm_bytes};"
                                f"reduce_axis_hops={st.reduce_axis_hops};"
                                f"full_over_cvc={ratio:.2f}",
                                dict(st.as_dict(), wall_us=us, scheme=scheme,
                                     reducer=reducer, full_over_cvc=ratio)))
                if results is not None:
                    results[name] = labels
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("comm_volume", run, __doc__))

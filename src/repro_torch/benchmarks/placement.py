"""Paper Fig. 3 + §4.1–4.2 — the allocation-policy study over a mesh: the
port's counterpart of the JAX package's ``benchmarks/placement.py``.

``fig3/bfs_{local,interleaved,blocked}``: rmat(10, 12) laid out by each
policy over 8 mesh positions (``placement.place_graph``; interleaved
permutes edge blocks), ``bfs_dd_dense`` on it, and the per-position bytes
of its edge arrays (``placement.position_bytes``): the largest and the
imbalance, the quantity behind the paper's fast-tier cliffs.
``fig4/migration_breakeven_rounds``: the §4.2 churn model's break-even for
moving 1 GiB against a 10 µs per-round gain (why migration stays off).

    python -m repro_torch.benchmarks.placement [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

from ..core import placement as pl
from ..core.algorithms import bfs
from ..core.mesh import Mesh
from .common import row, suite_main, timed
from .scaling import bench_graph

POSITIONS = 8


def run(graph=None, warmup: int = 1, iters: int = 1, device=None, results=None):
    """The Fig. 3/4 rows on ``graph = (g, source)`` (by default
    ``scaling.bench_graph()``); ``results`` receives each bfs row's
    distances."""
    g, source = bench_graph(device) if graph is None else graph
    mesh = Mesh({"data": POSITIONS}, device=g.device)
    rows = []
    for policy in pl.POLICIES:
        gp = pl.place_graph(g, mesh, ("data",), policy)
        (dist, _), us = timed(lambda: bfs.bfs_dd_dense(gp, source), warmup, iters)
        per = pl.position_bytes(gp, mesh, ("data",), policy)
        mx, mn = max(per), max(min(per), 1)
        name = f"fig3/bfs_{policy}"
        rows.append(row(name, us, f"max_dev_bytes={mx};imbalance={mx / mn:.2f}"))
        if results is not None:
            results[name] = dist
    be = pl.ChurnModel().breakeven_rounds(1 << 30, 10e-6)
    rows.append(row("fig4/migration_breakeven_rounds", 0.0,
                    f"rounds={be:.0f};verdict=migration_off"))
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("placement", run, __doc__))

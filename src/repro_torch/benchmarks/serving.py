"""Multi-source batched query serving — amortization + QPS/latency rows, the
port's counterpart of the JAX package's ``benchmarks/serving.py``.

B concurrent queries on one resident graph share every edge sweep
(core/multisource.py), so the amortized per-source edge cost undercuts the
sequential per-source cost.  Three row families on one graph:

* ``serving/seq_<algo>``          — B per-source ``*_dd_sparse`` runs;
  ``edges_per_source`` is the sequential baseline.
* ``serving/batched_<algo>_b8``   — one ``ms_<algo>`` run over the same B
  sources; ``edges_per_source`` is the amortized cost and
  ``bitwise_equal`` records lane-vs-per-source equality (checked here).
* ``serving/server_bfs``          — the GraphServer scheduler
  (launch/graph_serve.py) over 16 ragged-arrival requests on B slots: QPS
  plus p50/p99 enqueue→completion latency from per-request stamps, after
  a warm pass on an identical request set.

Rows carry ``RunStats`` fields plus ``edges_per_source``,
``bitwise_equal``, ``qps``, ``p50_us`` and ``p99_us``, so the JAX
package's ``ci_gate.py serve`` reads them unchanged.

    python -m repro_torch.benchmarks.serving [--emit-json PATH] [--device cpu]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core import multisource as ms
from ..core.algorithms import bfs, sssp
from ..launch.graph_serve import GraphServer, QueryRequest
from .common import row, suite_main, timed

N_SOURCES = 8
N_REQUESTS = 16


def containers(device=None):
    """``(g, sources)`` as the JAX suite builds them: rmat(10, 12, seed=7)
    with random weights (seed 8) at block size 128, and 8 sources drawn
    with seed 3."""
    from ..core.graph import from_coo
    from ..graphs import generators as gen

    src, dst, n = gen.rmat(10, 12, seed=7)
    w = gen.random_weights(len(src), seed=8)
    g = from_coo(src, dst, n, w, block_size=128, device=device)
    rng = np.random.default_rng(3)
    return g, [int(s) for s in rng.integers(0, n, N_SOURCES)]


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q))


def run(graphs=None, warmup: int = 1, iters: int = 3, device=None, results=None):
    """The serving rows on ``graphs = (g, sources)`` (by default
    ``containers()``).  ``results``, a dict, receives each row's labels:
    the seq rows' (B, n_pad) stack of per-source labels, the batched rows'
    lane matrix, and the server row's list of served requests."""
    g, sources = graphs if graphs is not None else containers(device)
    b = len(sources)
    rows = []
    for aname, per_source, batched in (("bfs", bfs.bfs_dd_sparse, ms.ms_bfs),
                                       ("sssp", sssp.sssp_dd_sparse, ms.ms_sssp)):
        # -- sequential baseline: B independent sparse-ladder runs ----------
        seq, us_seq = timed(lambda: [per_source(g, s) for s in sources],
                            warmup, iters)
        seq_edges = sum(st.edges_touched for _, st in seq)
        seq_stats = dict(seq[0][1].as_dict(), edges_touched=seq_edges,
                         sources=b, edges_per_source=seq_edges / b)
        rows.append(row(f"serving/seq_{aname}", us_seq,
                        f"b={b};edges_per_source={seq_edges / b:.0f}", seq_stats))

        # -- batched: one sweep per round serves every lane -----------------
        (labels, stb), us_b = timed(lambda: batched(g, sources), warmup, iters)
        exact = all(torch.equal(labels[i], seq[i][0]) for i in range(b))
        eps = stb.edges_touched / stb.sources
        bat_stats = dict(stb.as_dict(), edges_per_source=eps,
                         bitwise_equal=int(exact))
        rows.append(row(f"serving/batched_{aname}_b{N_SOURCES}", us_b,
                        f"b={b};edges_per_source={eps:.0f};equal={int(exact)}",
                        bat_stats))
        if results is not None:
            results[f"serving/seq_{aname}"] = torch.stack([lab for lab, _ in seq])
            results[f"serving/batched_{aname}_b{N_SOURCES}"] = labels

    # -- scheduler: QPS + tail latency over ragged arrivals ---------------
    def make_requests():
        return [QueryRequest(rid=i, source=sources[i % b], arrive_round=i // b)
                for i in range(N_REQUESTS)]

    server = GraphServer(g, algo="bfs", max_batch=b)
    server.serve(make_requests())   # warm pass; freed slots make it reusable
    t0 = time.perf_counter()
    done = server.serve(make_requests())
    wall = time.perf_counter() - t0
    lats = [(r.t_done - r.t_enqueue) * 1e6 for r in done]
    qps = len(done) / wall
    srv_stats = dict(server.eng.stats.as_dict(), qps=qps, requests=len(done),
                     max_batch=b, p50_us=_percentile(lats, 50),
                     p99_us=_percentile(lats, 99))
    rows.append(row("serving/server_bfs", wall * 1e6,
                    f"qps={qps:.2f};p50_ms={_percentile(lats, 50) / 1e3:.1f};"
                    f"p99_ms={_percentile(lats, 99) / 1e3:.1f};"
                    f"requests={len(done)}", srv_stats))
    if results is not None:
        results["serving/server_bfs"] = done
    return rows


if __name__ == "__main__":
    raise SystemExit(suite_main("serving", run, __doc__))

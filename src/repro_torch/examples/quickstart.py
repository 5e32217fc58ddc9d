"""Quickstart: the graph-analytics engine in ~40 lines, as
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On the card bfs, sssp, cc and pagerank relax through ``edge_relax`` and
expand their sparse rounds through ``advance``.
"""

from __future__ import annotations

import argparse

import numpy as np

from ..core.algorithms import bfs, cc, pagerank, sssp
from ..core.graph import from_coo
from ..graphs import generators as gen


def main(argv=None) -> dict:
    """Prints the JAX script's lines; returns ``{"lines": [...], "bfs":
    (dist, stats), "sssp": ..., "cc": ..., "pr": ...}``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    lines = []

    def say(line):
        print(line, flush=True)
        lines.append(line)

    # a high-diameter web-crawl-like graph (the regime the paper targets)
    src, dst, n = gen.web_crawl_like(16, 5, 8, 2, seed=0)
    w = gen.random_weights(len(src), seed=1)
    g = from_coo(src, dst, n, w, build_csc=True, device=args.device)       # CSR + CSC
    gsym = from_coo(src, dst, n, symmetrize=True, device=args.device)      # for cc
    source = int(np.argmax(np.bincount(src, minlength=n)))
    say(f"graph: n={g.n} m={g.m} source={source}")

    # data-driven sparse-worklist BFS (the paper's winning class)
    out = {"bfs": bfs.bfs_dd_sparse(g, source)}
    dist, stats = out["bfs"]
    say(f"bfs   : {stats.rounds} rounds, {stats.edges_touched} edge-slots, "
        f"reached={int((dist < 1e30).sum())}")

    # asynchronous delta-stepping SSSP
    out["sssp"] = sssp.sssp_delta(g, source, delta=4.0)
    say(f"sssp  : {out['sssp'][1].rounds} buckets")

    # non-vertex pointer-jumping CC (log-round, diameter-independent)
    out["cc"] = cc.cc_pointer_jump(gsym)
    labels, stats = out["cc"]
    ncomp = len(np.unique(labels[: g.n].cpu().numpy()))
    say(f"cc    : {stats.rounds} rounds, {ncomp} components")

    # residual-push PageRank
    out["pr"] = pagerank.pr_push(gsym)
    rank, stats = out["pr"]
    say(f"pr    : {stats.rounds} rounds, top vertex "
        f"{int(np.argmax(rank[: g.n].cpu().numpy()))}")
    out["lines"] = lines
    return out


if __name__ == "__main__":
    main()

"""Wall times of the quickstart main path on one CUDA card, repeated.

    python3 src/repro_torch/tools/time_main_path.py [--src DIR] [--repeat 8]

Builds the graphs of ``chip_smoke.py``'s main path
(``web_crawl_like(512, 13, 16, 3)`` with random weights as CSR+CSC, and
its symmetrized twin), runs each algorithm of that path once to warm up,
then ``--repeat`` more times in the same order under the "cuda" substrate,
and prints every synchronised wall time with their min, median and max as
one JSON line.  ``--src`` picks the source tree whose ``repro_torch`` is
timed (default: this checkout's ``src``), so that two commits can be
compared on one card in one call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="directory that holds the repro_torch to time")
    ap.add_argument("--repeat", type=int, default=8)
    ap.add_argument("--communities", type=int, default=512)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("time_main_path: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np

    import repro_torch as tc
    from repro_torch.core import operators as ops
    from repro_torch.core.algorithms import bfs, cc, pagerank, sssp
    from repro_torch.graphs import generators as gen_mod
    from repro_torch.kernels.graph_ops import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    build.load("graph_ops")
    src, dst, n = gen_mod.web_crawl_like(args.communities, 13, 16, 3, seed=0)
    w = gen_mod.random_weights(len(src), seed=1)
    g = tc.from_coo(src, dst, n, w, build_csc=True)
    gsym = tc.from_coo(src, dst, n, symmetrize=True, build_csc=True)
    source = int(np.argmax(np.bincount(src, minlength=n)))
    del src, dst, w
    runs = {
        "bfs_dd_sparse": lambda: bfs.bfs_dd_sparse(g, source),
        "bfs_dd_sparse(fused=False)": lambda: bfs.bfs_dd_sparse(g, source, fused=False),
        "sssp_delta": lambda: sssp.sssp_delta(g, source, delta=4.0),
        "cc_pointer_jump": lambda: cc.cc_pointer_jump(gsym),
        "cc_dd_sparse": lambda: cc.cc_dd_sparse(gsym),
        "pr_push": lambda: pagerank.pr_push(gsym),
        "pr_pull": lambda: pagerank.pr_pull(gsym),
    }
    walls = {name: [] for name in runs}
    with ops.substrate_scope("cuda"):
        for rep in range(args.repeat + 1):
            for name, fn in runs.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if rep:
                    walls[name].append((time.perf_counter() - t0) * 1e3)
    summary = {name: dict(min=min(v), median=statistics.median(v), max=max(v))
               for name, v in walls.items()}
    print(json.dumps({"src": args.src, "card": card, "m": g.m, "sym_m": gsym.m,
                      "repeat": args.repeat, "wall_ms": walls, "summary": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

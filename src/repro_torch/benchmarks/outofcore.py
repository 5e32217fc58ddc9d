"""Out-of-core tiered execution — the port's counterpart of the JAX
package's ``benchmarks/outofcore.py``: the same rows, under the same
names, on the same graph (``rmat(11, 13, seed=7)``, block 128, CSR+CSC).

The graph is persisted once through the store (``checkpoint.save_graph``)
and reopened mmap-backed (``open_graph``); then bfs and pagerank run on
the same streamed path twice:

* ``*_streamed`` — ``resident_shards=2``: the pool holds 2 of 16 shards,
  so the CSR is 8× the resident budget and every round streams (bfs and
  pr through the default fused dispatch, ``engine.run_streamed``);
* ``*_resident`` — a pool of all 16 shards: after the first cold pass
  every scheduled shard is a buffer hit.

``bfs_eager_streamed`` is the streamed bfs with ``fused=False`` (labels
and the stream counters must equal the fused row's), and
``dirop_streamed`` the direction-optimizing bfs, whose pull rounds stream
the store's CSC mirror (labels bitwise equal to the resident run).  Labels
are checked, not only timed: bfs bitwise equal across streamed,
all-resident and the plain ``Graph``; pagerank bitwise streamed against
all-resident and allclose to the plain graph.  Each row carries the full
``RunStats`` and ``shard_bytes``, so ``benchmarks/ci_gate.py ooc`` can
re-check ``h2d_bytes == shards_streamed * shard_bytes``.

    python -m repro_torch.benchmarks.outofcore [--emit-json PATH] [--device cpu]

Runs on the card; without one it raises unless given ``--device cpu``
(the plain versions on the CPU: no device number comes out of that run).
"""

from __future__ import annotations

import shutil
import tempfile

import numpy as np
import torch

from ..checkpoint import open_graph, save_graph
from ..core.algorithms import bfs, pagerank
from ..core.graph import _device, from_coo
from ..graphs import generators as gen
from .common import row, suite_main, time_call


def run(device=None):
    dev = _device(device)
    src, dst, n = gen.rmat(11, 13, seed=7)
    g = from_coo(src, dst, n, block_size=128, build_csc=True, device=dev)
    store = tempfile.mkdtemp(prefix="ooc_store_")
    rows = []
    try:
        save_graph(g, store, nshards=16)
        us = time_call(lambda: open_graph(store, resident_shards=2, device=dev).out_deg)
        mapped = isinstance(open_graph(store, device=dev)._host[0][0], np.memmap)
        rows.append(row("outofcore/store_open", us, f"nshards=16;mmap={int(mapped)}"))

        variants = {
            "streamed": open_graph(store, resident_shards=2, device=dev),
            "resident": open_graph(store, resident_shards=16, device=dev),
        }
        ratio = variants["streamed"].csr_bytes / max(
            variants["streamed"].resident_budget, 1)
        algos = {
            "bfs": lambda tg: bfs.bfs_dd_sparse(tg, 0),
            "pr": lambda tg: pagerank.pr_push(tg, max_iters=50),
        }
        refs = {"bfs": bfs.bfs_dd_sparse(g, 0)[0],
                "pr": pagerank.pr_push(g, max_iters=50)[0]}
        for aname, fn in algos.items():
            out = {}
            for vname, tg in variants.items():
                labels, stats = fn(tg)
                out[vname] = (labels, stats, tg)
            exact = torch.equal(out["streamed"][0], out["resident"][0])
            if aname == "bfs":
                exact = exact and torch.equal(out["streamed"][0], refs["bfs"])
            ok_ref = torch.allclose(out["streamed"][0], refs[aname], rtol=1e-5,
                                    atol=1e-8)
            for vname, (labels, stats, tg) in out.items():
                us = time_call(lambda fn=fn, tg=tg: fn(tg)[0])
                extra = {
                    "shard_bytes": tg.shard_bytes,
                    "csr_bytes": tg.csr_bytes,
                    "resident_budget": tg.resident_budget,
                    "budget_ratio": tg.csr_bytes / max(tg.resident_budget, 1),
                    "bitwise_equal": int(exact),
                    "ref_allclose": int(ok_ref),
                }
                rows.append(row(
                    f"outofcore/{aname}_{vname}", us,
                    f"h2d_kb={stats.h2d_bytes / 1024:.0f};"
                    f"streamed={stats.shards_streamed};"
                    f"hits={stats.buffer_hits};ratio={ratio:.0f}x;"
                    f"equal={int(exact)}",
                    dict(stats.as_dict(), **extra)))
            if aname == "bfs":
                fused_labels, fused_stats = out["streamed"][:2]

        # eager (per-round) streamed bfs: fusion changes fetches only
        tg = open_graph(store, resident_shards=2, device=dev)
        labels, stats = bfs.bfs_dd_sparse(tg, 0, fused=False)
        eager_exact = bool(
            torch.equal(labels, fused_labels)
            and stats.h2d_bytes == fused_stats.h2d_bytes
            and stats.shards_streamed == fused_stats.shards_streamed
            and stats.edges_touched == fused_stats.edges_touched)
        us = time_call(lambda: bfs.bfs_dd_sparse(tg, 0, fused=False)[0])
        rows.append(row(
            "outofcore/bfs_eager_streamed", us,
            f"h2d_kb={stats.h2d_bytes / 1024:.0f};"
            f"streamed={stats.shards_streamed};equal={int(eager_exact)}",
            dict(stats.as_dict(), bitwise_equal=int(eager_exact),
                 budget_ratio=tg.csr_bytes / max(tg.resident_budget, 1),
                 shard_bytes=tg.shard_bytes)))

        # direction-optimizing bfs out of core: pull rounds stream the
        # store's CSC mirror
        ref_dirop = bfs.bfs_dirop(g, 0)[0]
        tg = open_graph(store, resident_shards=2, device=dev)
        labels, stats = bfs.bfs_dirop(tg, 0)
        dirop_exact = torch.equal(labels, ref_dirop)
        us = time_call(lambda: bfs.bfs_dirop(tg, 0)[0])
        rows.append(row(
            "outofcore/dirop_streamed", us,
            f"h2d_kb={stats.h2d_bytes / 1024:.0f};"
            f"pulls={stats.pull_rounds};equal={int(dirop_exact)}",
            dict(stats.as_dict(), bitwise_equal=int(dirop_exact),
                 budget_ratio=tg.csr_bytes / max(tg.resident_budget, 1),
                 shard_bytes=tg.shard_bytes)))
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return rows


def main(argv=None) -> int:
    return suite_main("outofcore", run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())

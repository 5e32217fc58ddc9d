"""Kernel micro-benchmarks, the port's counterpart of the JAX package's
``benchmarks/kernels_bench.py`` (the ``kernels`` suite of
``benchmarks/run.py``): the same rows at the same shapes and seeds, under
the same names and ``derived`` keys.  Flash attention, block-sparse SpMM
and the embedding bag are timed through their kernel wrappers; the graph
edge-relaxation operators and one end-to-end sparse-ladder BFS are timed
once per substrate of the port (``"torch"``, ``"cuda"``), whose names take
the places of the reference's ``"jnp"`` and ``"pallas"``.

    python -m repro_torch.benchmarks.kernels_bench [--emit-json PATH] [--device cpu]

Runs on the card; without one it raises unless given ``--device cpu``
(where every wrapper takes its plain version).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import frontier as fr
from ..core import operators as ops
from ..core.algorithms import bfs, tc
from ..core.graph import _device, from_coo
from ..graphs import generators as gen
from ..kernels.embedding_bag.embedding_bag import embedding_bag
from ..kernels.embedding_bag.ref import embedding_bag_ref
from ..kernels.flash_attention.flash_attention import flash_attention_bhsd
from ..kernels.flash_attention.ref import attention_ref
from ..kernels.spmm_bsr.spmm_bsr import spmm_bsr, to_bsr
from .common import row, suite_main, time_call


def _t(a, dev, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)


def _graph_ops_rows(dev, rng):
    """Per-substrate timings for push/pull/advance+relax/intersect and e2e BFS."""
    rows = []
    src, dst, n = gen.rmat(10, 12, seed=1)
    g = from_coo(src, dst, n, block_size=512, build_csc=True, device=dev)
    gsym = from_coo(src, dst, n, block_size=512, symmetrize=True, device=dev)
    adj, osrc, odst = tc.oriented_adjacency(gsym)
    ochunk = 4096
    opad = -(-osrc.shape[0] // ochunk) * ochunk
    fill = torch.full((opad - osrc.shape[0],), gsym.sentinel, dtype=torch.int32, device=dev)
    osrc_p, odst_p = torch.cat([osrc, fill]), torch.cat([odst, fill])
    sv = _t(rng.normal(size=g.n_pad).astype(np.float32), dev)
    active = _t(rng.random(g.n_pad) < 0.5, dev)
    active[g.sentinel] = False
    init = g.vertex_full(torch.finfo(torch.float32).max, torch.float32)
    cap = g.block_size
    budget = 4 * g.block_size
    f = fr.compact(active, cap, g.sentinel)

    for sub in ops.SUBSTRATES:
        def push(s=sub):
            return ops.push_dense(g, sv, active, init, kind="min", substrate=s)

        def pull(s=sub):
            return ops.pull_dense(g, sv, active, init, kind="min", substrate=s)

        def adv_relax(s=sub):
            batch = ops.advance_sparse(g, f, budget, substrate=s)
            return ops.relax_batch(batch, sv, init, kind="min", substrate=s)

        def isect(s=sub):
            return ops.intersect_batch(adj, osrc_p[:ochunk], odst_p[:ochunk],
                                       sentinel=gsym.sentinel, substrate=s)

        rows.append(row(f"kern/graph_push[{sub}]", time_call(push),
                        f"m={g.m};edge_slots={g.m_pad}"))
        rows.append(row(f"kern/graph_pull[{sub}]", time_call(pull),
                        f"m={g.m};edge_slots={g.m_pad}"))
        rows.append(row(f"kern/graph_advance_relax[{sub}]", time_call(adv_relax),
                        f"cap={cap};budget={budget}"))
        rows.append(row(f"kern/graph_intersect[{sub}]", time_call(isect),
                        f"chunk={ochunk};dmax={adj.shape[1]}"))
        with ops.substrate_scope(sub):
            us = time_call(lambda: bfs.bfs_dd_sparse(g, 0)[0])
            _, stats = bfs.bfs_dd_sparse(g, 0)
        rows.append(row(f"kern/graph_bfs_e2e[{sub}]", us,
                        f"substrate={stats.substrate};rounds={stats.rounds};"
                        f"edges_touched={stats.edges_touched}"))
    return rows


def kernel_inputs(dev, rng):
    """The inputs of the flash-attention, SpMM and embedding-bag rows, drawn
    from ``rng`` in the reference's order: ``(q, k, v)``, ``(indices,
    blocks, x)`` and ``(ids, weights, table)``, all on ``dev``."""
    bh, s, d = 2, 256, 64
    flash = tuple(_t(rng.normal(size=(bh, s, d)), dev, torch.float32) for _ in range(3))
    n, m, f = 512, 4000, 128
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    w = rng.normal(size=m).astype(np.float32)
    idx, blocks = to_bsr(src, dst, w, n)
    x = _t(rng.normal(size=(n, f)), dev, torch.float32)
    spmm = (_t(idx, dev), _t(blocks, dev), x)
    b, l, vv, dd = 32, 10, 10_000, 128
    ids = _t(rng.integers(0, vv, (b, l)), dev, torch.int32)
    ws = torch.ones((b, l), dtype=torch.float32, device=dev)
    table = _t(rng.normal(size=(vv, dd)), dev, torch.float32)
    return flash, spmm, (ids, ws, table)


def run(device=None):
    """The rows of the reference's ``kernels_bench.run()``, drawn from
    ``np.random.default_rng(0)`` in the same order, on ``device`` (the
    card by default)."""
    dev = _device(device)
    rng = np.random.default_rng(0)
    flash, spmm, bag = kernel_inputs(dev, rng)
    rows = []
    # flash attention
    q, k, v = flash
    bh, s, d = q.shape
    us_k = time_call(lambda: flash_attention_bhsd(q, k, v))
    us_r = time_call(lambda: attention_ref(q, k, v))
    flops = 4 * bh * s * s * d
    rows.append(row("kern/flash_attn_256", us_k, f"ref_us={us_r:.0f};flops={flops}"))

    # spmm
    idx, blocks, x = spmm
    us_k = time_call(lambda: spmm_bsr(idx, blocks, x))
    nnzb = int((idx >= 0).sum())
    f = x.shape[1]
    rows.append(row("kern/spmm_bsr_512", us_k,
                    f"nnz_blocks={nnzb};mxu_flops={nnzb * 2 * 128 * 128 * f}"))

    # embedding bag
    ids, ws, table = bag
    b, l = ids.shape
    us_k = time_call(lambda: embedding_bag(ids, ws, table))
    us_r = time_call(lambda: embedding_bag_ref(ids, ws, table))
    rows.append(row("kern/embedding_bag_32x10", us_k,
                    f"ref_us={us_r:.0f};rows_gathered={b * l}"))

    # graph edge-relaxation substrate (torch vs cuda)
    rows.extend(_graph_ops_rows(dev, rng))
    return rows


def main(argv=None) -> int:
    return suite_main("kernels", run, __doc__, argv)


if __name__ == "__main__":
    raise SystemExit(main())

"""Triangle counting by degree-ordered orientation + sorted intersection, as
in ``repro.core.algorithms.tc``.

Orientation sends each undirected edge {u, v} from the lower (deg, id)
endpoint to the higher, so every triangle is counted exactly once and the
oriented out-degree stays small on power-law graphs.  Each oriented edge
(u, v) intersects N+(u) with N+(v) over the padded, sorted oriented
adjacency, through ``operators.intersect_batch`` (the ``intersect``
kernel under ``"cuda"``), or on a sharded graph one slice of the oriented
list per shard (``ShardedGraph.sharded_intersect``).  The count is exact
integer arithmetic, so it is the same at every chunk size, on both
substrates and at every (placement, ndev).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import operators as ops
from ..engine import RunStats
from ..graph import round_up


def oriented_adjacency(g):
    """Host-side: the (n_pad, dmax) sorted oriented adjacency (sentinel-
    padded) plus the oriented edge list, built with numpy exactly as the
    reference builds it and put on the graph's device.  Graph must be
    symmetric.  Reads ``src_idx``/``col_idx``/``out_deg`` back once."""
    src_all = g.src_idx.cpu().numpy()
    dst_all = g.col_idx.cpu().numpy()
    real = src_all != g.sentinel
    src = src_all[real].astype(np.int64)
    dst = dst_all[real].astype(np.int64)
    deg = g.out_deg.cpu().numpy()
    # rank = (degree, id) lexicographic
    rank = deg.astype(np.int64) * (g.n_pad + 1) + np.arange(g.n_pad)
    keep = rank[src] < rank[dst]
    osrc, odst = src[keep], dst[keep]
    odeg = np.bincount(osrc, minlength=g.n_pad)
    dmax = max(int(odeg.max()), 1)
    adj = np.full((g.n_pad, dmax), g.sentinel, dtype=np.int32)
    order = np.lexsort((odst, osrc))
    osrc, odst = osrc[order], odst[order]
    starts = np.zeros(g.n_pad + 1, dtype=np.int64)
    np.cumsum(odeg, out=starts[1:])
    idx_in_row = np.arange(osrc.shape[0]) - starts[osrc]
    adj[osrc, idx_in_row] = odst
    adj.sort(axis=1)  # sentinel (large) sorts to the end; rows stay sorted
    dev = g.device
    return (torch.from_numpy(adj).to(dev),
            torch.from_numpy(osrc.astype(np.int32)).to(dev),
            torch.from_numpy(odst.astype(np.int32)).to(dev))


def tc_count(g, edge_chunk: int = 32_768):
    """Total triangle count.  Returns (count, stats).

    ``edge_chunk`` bounds the (chunk, dmax) working set of the plain
    version's gathers, which go chunk by chunk; the kernel takes the whole
    list in one launch (or a few, to keep its candidate indices in int32)
    and writes one count per chunk.  The per-chunk counts are summed on the
    device in int64 and fetched once.

    On a ``ShardedGraph`` of D > 1 shards the canonical oriented list is
    cut by edge chunk over the mesh: each shard counts its slice of
    ``per`` edges (a multiple of ``edge_chunk``) with one
    ``intersect_count``, and the exact int32 partials are summed (the
    reference's psum, charged as one scalar collective)."""
    adj, osrc, odst = oriented_adjacency(g)
    dmax = adj.shape[1]
    ne = int(osrc.shape[0])
    sharded = getattr(g, "sharded_intersect", None)
    if sharded is not None and g.ndev > 1:
        per = round_up(max(ne, 1), g.ndev * edge_chunk) // g.ndev
        pad = torch.full((g.ndev * per - ne,), g.sentinel, dtype=torch.int32,
                         device=g.device)
        osrc = torch.cat([osrc, pad]).reshape(g.ndev, per)
        odst = torch.cat([odst, pad]).reshape(g.ndev, per)
        total = sharded(adj, osrc, odst, ops.get_substrate(), chunk=edge_chunk)
        stats = RunStats.from_graph(g, rounds=max(g.ndev * per // edge_chunk, 1),
                                    edges_touched=g.ndev * per * dmax)
        stats.add_comm(g, relaxes=0, scalar_collectives=1)
        return int(total), stats
    ne_pad = round_up(max(ne, 1), edge_chunk)
    pad = torch.full((ne_pad - ne,), g.sentinel, dtype=torch.int32,
                     device=g.device)
    osrc = torch.cat([osrc, pad])
    odst = torch.cat([odst, pad])

    counts = ops.intersect_batch(adj, osrc, odst, sentinel=g.sentinel,
                                 chunk=edge_chunk)
    total = counts.sum(dtype=torch.int64)
    stats = RunStats.from_graph(g, rounds=max(ne_pad // edge_chunk, 1),
                                edges_touched=int(ne_pad) * dmax)
    return int(total), stats


VARIANTS = {"orient_intersect": tc_count}

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

import torch

from .. import operators as ops
from ..engine import RunStats
from ..graph import round_up


def oriented_adjacency(g):
    """The (n_pad, dmax) sorted oriented adjacency (sentinel-padded) plus
    the oriented edge list, built in torch on the graph's device, bitwise
    the reference's numpy build.  Graph must be symmetric.  The host
    fetches two scalars, the list's length and ``dmax``.

    The real edges are the flat views' non-sentinel slots (a
    ``ShardedGraph`` interleaves its padding); one stable sort by (src,
    dst) makes the list canonical whatever the input's order."""
    src = g.src_idx.reshape(-1).long()
    dst = g.col_idx.reshape(-1).long()
    n_pad, sentinel = g.n_pad, g.sentinel
    # rank = (degree, id) lexicographic
    rank = g.out_deg.long() * (n_pad + 1) + torch.arange(n_pad, device=g.device)
    keep = (src != sentinel) & (rank[src] < rank[dst])
    odeg = torch.zeros(n_pad, dtype=torch.int64, device=g.device).index_add_(
        0, src, keep.long())
    ne, dmax = torch.stack([odeg.sum(), odeg.max()]).tolist()
    dmax = max(dmax, 1)
    kept = torch.nonzero_static(keep, size=ne).squeeze(1)
    osrc, odst = src[kept], dst[kept]
    order = torch.sort(osrc * n_pad + odst, stable=True).indices
    osrc, odst = osrc[order], odst[order]
    starts = torch.cumsum(odeg, 0) - odeg
    idx_in_row = torch.arange(ne, device=g.device) - starts[osrc]
    adj = torch.full((n_pad * dmax,), sentinel, dtype=torch.int32, device=g.device)
    adj[osrc * dmax + idx_in_row] = odst.int()
    # sentinel (large) sorts to the end; rows stay sorted
    adj = torch.sort(adj.view(n_pad, dmax), dim=1).values
    return adj, osrc.int(), odst.int()


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
